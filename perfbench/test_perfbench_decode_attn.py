"""The reader of decode attention's roofline share
(``decode.attn_roofline``) on synthetic timelines: the valid slots a step
must read, by the window's prompt length and the spans' steps, over the
``decode_attn_*`` kernels that lie inside ``serve.decode`` spans."""

import re

import pytest

from perfbench.counts.peaks import HBM_BYTES_PER_S
from perfbench.lib import harness
from perfbench.test_perfbench_decode_graph import GROUPED, _named_ctx
from perfbench.test_perfbench_spans import OPS, SPANS, _ctx, _read
from repro_torch.obs import trace

# the kernel's passes, as the profiler names them (cut short)
SCORES = "void (anonymous namespace)::decode_attn_scores<128, float, " \
    "__nv_bfloat16>(Params)"
PV = "void (anonymous namespace)::decode_attn_pv<128, float, " \
    "__nv_bfloat16>(Params)"
REDUCE = "void (anonymous namespace)::decode_attn_reduce<__nv_bfloat16>" \
    "(Params)"
# 3 layers of 4 query heads over 2 kv heads of 8, an f32 cache, bf16 q
CFG = {"num_hidden_layers": 3, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 8, "cache_dtype": "float32",
       "compute_dtype": "bfloat16", "torch_dtype": "bfloat16"}


def _reader():
    return harness.load_module("metrics", "decode.attn_roofline")


def _bytes(batch: int, slots: int) -> int:
    """A step's layer by hand: K and V of each slot, kv head and row at 4
    bytes a value; q and the output at 2."""
    return batch * (2 * slots * 2 * 8 * 4 + 2 * 4 * 8 * 2)


def test_reads_the_valid_slots_over_the_kernels_inside_decode():
    """SPANS' calls: 2 steps and 1 step at batch 4 after prompts of 10, so
    the steps read 11, 12 and 11 slots; the kernels wholly inside the calls
    take 400 us; one straddling a call's edge, one between the calls (no
    decode there) and a GEMM inside are left out."""
    ops = [(SCORES, 100, 200), (PV, 200, 350), (REDUCE, 400, 450),
           (SCORES, 2100, 2200), (PV, 950, 1050), (SCORES, 1200, 1300),
           ("nvjet_tst_64x8", 600, 700)]
    rec = {"cfg": CFG, "prompt_len": 10}
    got = _read("decode.attn_roofline", _named_ctx(SPANS, ops, rec))
    nbytes = 3 * (_bytes(4, 11) + _bytes(4, 12) + _bytes(4, 11))
    assert got == pytest.approx(100.0 * nbytes / HBM_BYTES_PER_S / 400e-6)


def test_a_window_caps_the_slots():
    """With a window of 11, the second step reads 11 slots, not 12."""
    ops = [(SCORES, 100, 300)]
    rec = {"cfg": dict(CFG, sliding_window=11), "prompt_len": 10}
    got = _read("decode.attn_roofline", _named_ctx(SPANS, ops, rec))
    assert got == pytest.approx(
        100.0 * 3 * 3 * _bytes(4, 11) / HBM_BYTES_PER_S / 200e-6)


def test_step_bytes_at_the_generate_cells():
    """A step's layer at the cells' shapes: deepseek-moe-16b at B 32 and
    545 slots, 16 kv heads of 128 in f32, 286 MB; the mixtral stage at
    2,112 slots over 8 kv heads, 554 MB."""
    step_bytes = _reader().step_bytes
    ds = dict(CFG, num_attention_heads=16, num_key_value_heads=16,
              head_dim=128)
    mx = dict(CFG, num_attention_heads=48, num_key_value_heads=8,
              head_dim=128)
    assert step_bytes(ds, 32, 545) == 32 * (2 * 545 * 16 * 128 * 4
                                            + 2 * 16 * 128 * 2)
    assert step_bytes(ds, 32, 545) / 1e6 == pytest.approx(285.9, abs=0.1)
    assert step_bytes(mx, 32, 2112) / 1e6 == pytest.approx(554.4, abs=0.1)


def test_without_its_kernels_reads_nothing(monkeypatch):
    """No decode-attention kernel (a program without it), only kernels
    outside every decode span, no decode span, no configuration or prompt
    length, or a program that cannot place its spans on the profiler's
    timeline: nothing, and nothing raised."""
    rec = {"cfg": CFG, "prompt_len": 10}
    for spans, ops, r in ((SPANS, [("nvjet", 100, 200), (GROUPED, 300, 400)],
                           rec),
                          (SPANS, [(SCORES, 1200, 1800)], rec),
                          ([], [(SCORES, 100, 300)], rec),
                          (SPANS, [(SCORES, 100, 300)], {"cfg": CFG}),
                          (SPANS, [(SCORES, 100, 300)], {"prompt_len": 10})):
        assert _read("decode.attn_roofline", _named_ctx(spans, ops, r)) \
            is None
    assert _read("decode.attn_roofline", _ctx(SPANS, OPS)) is None
    monkeypatch.delattr(trace, "profiler_us")
    assert _read("decode.attn_roofline",
                 _named_ctx(SPANS, [(SCORES, 100, 300)], rec)) is None


def test_the_kernel_source_names_its_passes_as_the_reader_reads_them():
    """Every ``__global__`` function of the source starts ``decode_attn_``,
    the names the reader matches."""
    from repro_torch.kernels._build import CSRC
    src = (CSRC / "decode_attention.cu").read_text()
    names = re.findall(r"__global__ void (?:__launch_bounds__\(\w+\) )?"
                       r"(\w+)\(", src)
    assert names and all(n.startswith("decode_attn_") for n in names)
    assert len(names) == 3
