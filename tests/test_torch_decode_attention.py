"""The decode-attention kernel's plain version (``kernels/decode_attention``)
on the CPU: equal bit for bit to the model's decode attention on the CPU
(``models.transformer.decode_attention``, which writes the step's k and v
into the cache and runs ``dot_attention`` over it); the checks the wrapper
and the binding make before any launch; the split of the valid slots.
The kernel itself runs only on the card (``tests/test_torch_gpu.py``)."""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention.kernel import (
    HEAD_DIMS, decode_attention_fwd, heads_per_block, scale, splits)
from repro_torch.models import transformer

BF, F32 = torch.bfloat16, torch.float32

# (B, H, Hkv, S, D, window, pos, q dtype, cache dtype): MHA at deepseek-
# moe-16b's shape and GQA 6:1 at the mixtral stage's (two batch rows), G =
# 12 and MQA at G = 16 (more heads than a block takes), D = 16, 64, 128,
# 256; rolling buffers before and after they wrap; pos 0 and S - 1; f32
# and bf16 caches, an f32 model
CASES = {
    "dsmoe_mha": (2, 16, 16, 576, 128, 0, 544, BF, F32),
    "mixtral_gqa6": (2, 48, 8, 2176, 128, 0, 2112, BF, F32),
    "starcoder2_gqa12": (1, 48, 4, 300, 128, 0, 299, BF, F32),
    "rg_mqa_d256": (2, 16, 1, 257, 256, 0, 130, BF, F32),
    "d64_bf16_cache": (3, 8, 2, 300, 64, 0, 150, BF, BF),
    "d64_f32_model": (3, 8, 2, 300, 64, 0, 211, F32, F32),
    "d128_f32_model_bf16_cache": (2, 8, 8, 200, 128, 0, 199, F32, BF),
    "d256_pos0": (2, 16, 8, 512, 256, 0, 0, BF, F32),
    "d16_smoke": (4, 4, 2, 32, 16, 0, 31, BF, F32),
    "rolling_before_wrap": (2, 16, 8, 64, 256, 64, 40, BF, F32),
    "rolling_at_wrap": (2, 16, 8, 64, 256, 64, 63, BF, F32),
    "rolling_after_wrap": (2, 16, 8, 64, 256, 64, 200, BF, F32),
    "rolling_f32_model": (2, 8, 2, 48, 64, 48, 100, F32, F32),
}


def _inputs(B, H, Hkv, S, D, q_dtype, cache_dtype, seed):
    rng = np.random.default_rng(seed)

    def rand(*shape, dtype):
        return torch.as_tensor(rng.standard_normal(shape, np.float32)) \
            .to(dtype)
    q = rand(B, 1, H, D, dtype=q_dtype)
    k_new, v_new = (rand(B, 1, Hkv, D, dtype=q_dtype) for _ in range(2))
    # every slot filled, those past the position too: they must not count
    cache = {n: rand(B, S, Hkv, D, dtype=cache_dtype) for n in ("k", "v")}
    return q, k_new, v_new, cache


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_equals_decode_attention_on_the_cpu(case):
    """The model's decode step over a layer's cache, then the plain
    version over the cache it left, at the same position: equal bit for
    bit, in q's dtype."""
    B, H, Hkv, S, D, window, at, q_dtype, cache_dtype = CASES[case]
    q, k_new, v_new, cache = _inputs(B, H, Hkv, S, D, q_dtype, cache_dtype,
                                     seed=len(case))
    pos = torch.tensor(at)
    ctx = transformer.Ctx(cfg=None, mode="decode", pos=pos,
                          positions=pos.view(1))
    got = transformer.decode_attention(q, k_new, v_new, cache, ctx,
                                       window=window)
    slot = at % S if window else at
    assert torch.equal(cache["k"][:, slot], k_new[:, 0].to(cache_dtype))
    want = decode_attention_ref(q, cache["k"], cache["v"], pos)
    assert got.dtype == want.dtype == q_dtype
    assert torch.equal(got, want)


def test_plain_version_counts_the_valid_slots_alone():
    """Other values in the slots past the position change nothing; a NaN
    in a valid slot does. (The plain version masks the slots past the
    position, as ``dot_attention`` does; the kernel does not load them,
    ``tests/test_torch_gpu.py``.)"""
    q, _, _, cache = _inputs(2, 8, 2, 100, 64, BF, F32, seed=3)
    pos = torch.tensor(40)
    want = decode_attention_ref(q, cache["k"], cache["v"], pos)
    k, v = cache["k"].clone(), cache["v"].clone()
    k[:, 41:], v[:, 41:] = 3 * k[:, 41:] + 1, -v[:, 41:]
    assert torch.equal(decode_attention_ref(q, k, v, pos), want)
    k[:, 40] = float("nan")
    assert not bool(torch.isfinite(decode_attention_ref(q, k, v, pos)).all())


@pytest.mark.parametrize("window, match", [(32, "window"),
                                           (64, "CUDA device")])
def test_the_wrapper_refuses_a_rolling_buffer_past_its_window(window, match):
    """A rolling buffer longer than its window raises, and so does a call
    on the CPU: the kernel has no CPU route (the model's CPU decode runs
    ``dot_attention``)."""
    q, _, _, cache = _inputs(1, 4, 2, 64, 16, BF, F32, seed=4)
    before = decode_attention.launches
    with pytest.raises(ValueError, match=match):
        decode_attention(q, cache["k"], cache["v"], torch.tensor(3),
                         window=window)
    assert decode_attention.launches == before


@pytest.mark.parametrize("change, match", [
    ({"D": 96}, "D in"),
    ({"H": 6, "Hkv": 4}, "multiple of Hkv"),
    ({"q_dtype": torch.float16}, "f32 or bf16"),
    ({"cache_dtype": torch.float16}, "f32 or bf16"),
    ({"Sq": 2}, r"q \[B, 1, H, D\]"),
    ({}, "CUDA device"),
])
def test_the_binding_checks_before_any_launch(change, match):
    """Shapes, head dims and dtypes the kernel has no instance for, and
    tensors off the card, raise before the library is loaded."""
    p = dict(B=2, H=8, Hkv=2, S=32, D=64, Sq=1, q_dtype=BF, cache_dtype=F32)
    p.update(change)
    q = torch.zeros(p["B"], p["Sq"], p["H"], p["D"], dtype=p["q_dtype"])
    k = torch.zeros(p["B"], p["S"], p["Hkv"], p["D"], dtype=p["cache_dtype"])
    with pytest.raises(ValueError, match=match):
        decode_attention_fwd(q, k, k.clone(), torch.tensor(3))


@pytest.mark.parametrize("blocks, S, want", [
    (512, 576, 3),        # deepseek-moe-16b: 16 kv heads x 32 rows
    (256, 2176, 5),       # the mixtral stage: 8 kv heads x 32 rows
    (8, 32, 1),           # a smoke model: no split under 64 slots
    (1, 100_000, 1056),   # one block, a long cache: about two waves
    (4096, 4096, 1),      # more blocks than two waves already
])
def test_splits_fill_two_waves_from_the_shapes(blocks, S, want):
    """Splits of the slot range: about two waves of 4 blocks on each of
    132 SMs, none under 64 slots of the full cache; the position plays no
    part, so a captured step replays at every position."""
    assert splits(blocks, S, 132) == want
    assert blocks * want >= min(2 * 4 * 132, blocks * math.ceil(S / 64))


def test_the_binding_mirrors_the_source():
    """The head dims the source instantiates and the query heads a block
    takes (1 for MHA, else 8) are the binding's."""
    import re
    from repro_torch.kernels._build import CSRC
    src = (CSRC / "decode_attention.cu").read_text()
    cases = re.findall(r"case (\d+): return launch<", src)
    assert tuple(int(d) for d in cases) == HEAD_DIMS
    assert "heads == 1 ? launch_d<1, KV, Q>" in src
    assert "launch_d<8, KV, Q>" in src
    assert [heads_per_block(G) for G in (1, 2, 6, 8, 12, 16)] == \
        [1, 8, 8, 8, 8, 8]


@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_scale_is_the_f32_reciprocal_of_sqrt_d(D):
    want = np.float32(1) / np.float32(math.sqrt(D))
    assert scale(D) == float(want)
