"""The port's serving engine on the CPU against the JAX package's."""

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import zoo as jzoo
from repro.serve import ServeEngine as JaxServeEngine
import repro_torch.configs as tconfigs
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import load_jax_params
from repro_torch.serve import ServeEngine


@pytest.fixture(scope="module")
def engines():
    jcfg = jconfigs.get_smoke("llama3_2_1b").scaled(compute_dtype="float32")
    jm = jzoo.build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = tzoo.build(tconfigs.get_smoke("llama3_2_1b").scaled(
        compute_dtype="float32"), device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return (JaxServeEngine(jm, params, max_seq=64),
            ServeEngine(tm, max_seq=64, device="cpu"))


@pytest.mark.parametrize("B,P,new,seed", [(3, 16, 8, 1), (2, 5, 12, 2)])
def test_generate_matches_jax_engine(engines, B, P, new, seed):
    jeng, teng = engines
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (B, P),
                                            0, 256), np.int32)
    ref = jeng.generate(prompts, max_new_tokens=new)
    out = teng.generate(prompts, max_new_tokens=new)
    assert set(out) == set(ref)
    assert out["tokens"].dtype == np.int32 and out["tokens"].shape == (B, new)
    assert np.array_equal(out["tokens"], ref["tokens"])
    assert out["decode_tok_per_s"] > 0 and out["prefill_s"] > 0
    again = teng.generate(prompts, max_new_tokens=new)    # greedy: deterministic
    assert np.array_equal(again["tokens"], out["tokens"])


def test_generate_past_max_seq_raises(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="full"):
        teng.generate(np.zeros((1, 60), np.int32), max_new_tokens=8)


def test_generate_with_frames_matches_jax_engine():
    """An encoder-decoder served with ``frames``: whisper's smoke config at
    f32, greedy tokens equal to the reference engine's."""
    jcfg = jconfigs.get_smoke("whisper_base").scaled(compute_dtype="float32")
    jm = jzoo.build(jcfg)
    params = jm.init(jax.random.PRNGKey(3))
    tm = tzoo.build(tconfigs.get_smoke("whisper_base").scaled(
        compute_dtype="float32"), device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, jcfg.vocab, (3, 4)).astype(np.int32)
    frames = rng.normal(size=(3, jcfg.encoder.seq, jcfg.d_model)).astype(
        np.float32)
    ref = JaxServeEngine(jm, params, max_seq=16).generate(
        prompts, max_new_tokens=7, frames=frames)
    out = ServeEngine(tm, max_seq=16, device="cpu").generate(
        prompts, max_new_tokens=7, frames=frames)
    assert out["tokens"].shape == (3, 7)
    assert np.array_equal(out["tokens"], ref["tokens"])


def test_engine_device_must_match_model(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="engine asked"):
        ServeEngine(teng.model, max_seq=8, device="meta")


def test_generate_bf16_compute_on_cpu():
    """The serving path at bf16 compute (the card's type) runs end to end."""
    cfg = tconfigs.get_smoke("llama3.2-1b")
    eng = ServeEngine(tzoo.build(cfg, device="cpu", dtype=torch.bfloat16),
                      max_seq=32, device="cpu")
    out = eng.generate(np.arange(16, dtype=np.int32).reshape(2, 8), 6)
    assert out["tokens"].shape == (2, 6)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab)).all()


# ---------------------------------------------------------------------------
# the decode position, held on the device
# ---------------------------------------------------------------------------


def _capturable_model(arch, dtype, **scaled):
    """A smoke model of ``arch`` computing in ``dtype``, its parameters
    drawn from seed 0."""
    cfg = tconfigs.get_smoke(arch).scaled(compute_dtype=dtype, **scaled)
    return tzoo.build(cfg, device="cpu")


# a full-attention model; local and global layers decoded past their window
# of 8; the MoE capacity path; the dropless grouped path (capacity factor
# E / k), windowed
CASES = {
    "full": ("llama3_2_1b", {}),
    "window": ("gemma3_12b", {}),
    "moe_capacity": ("deepseek_moe_16b", {}),
    "moe_grouped": ("mixtral_8x22b", {"n_experts": 8, "capacity_factor": 4.0}),
}


def _tensors(cache):
    return [(si, bj, n, t) for si, seg in enumerate(cache["segments"])
            for bj, c in seg.items() for n, t in c.items()]


def test_advance_counts_on_the_host_alone():
    """``Model.advance`` counts steps run outside ``decode_step`` (the
    engine's replays) against the cache's capacity: it raises before
    they would overrun it, and moves nothing on the device; each
    ``decode_step`` counts its own, and a prefill starts the count anew."""
    model = _capturable_model("llama3_2_1b", "float32")
    tok = torch.zeros((1, 4), dtype=torch.long)
    with torch.inference_mode():
        _, cache = model.prefill({"tokens": tok}, model.init_cache(1, 8))
        model.advance(cache, 3)
        assert int(cache["pos"]) == 4
        with pytest.raises(ValueError, match="full"):
            model.advance(cache, 2)
        model.decode_step(cache, tok[:, :1])
        with pytest.raises(ValueError, match="full"):
            model.decode_step(cache, tok[:, :1])
        assert int(cache["pos"]) == 5
        _, cache = model.prefill({"tokens": tok}, cache)
        model.advance(cache, 4)
        assert int(cache["pos"]) == 4


@pytest.mark.parametrize("case", ["window", "moe_capacity"])
def test_engine_cache_reuse_carries_no_stale_state(case):
    """Two ``generate`` calls on one engine, the second with other and
    shorter prompts, equal each call on a fresh engine: the tokens, and
    the kept cache after the second call tensor for tensor. The engine
    keeps one cache for the batch size, and replaces it at a call of
    another; on the CPU every step is eager."""
    from repro_torch.obs import metrics
    arch, scaled = CASES[case]
    model = _capturable_model(arch, "float32", **scaled)
    rng = np.random.default_rng(6)
    first = rng.integers(0, model.cfg.vocab, (2, 11)).astype(np.int32)
    second = rng.integers(0, model.cfg.vocab, (2, 5)).astype(np.int32)
    engine = ServeEngine(model, max_seq=24, device="cpu")
    eager = metrics.counter("bullion.serve.decode_eager_steps").value
    a = engine.generate(first, 9)["tokens"]
    kept = engine._kept
    b = engine.generate(second, 12)["tokens"]
    assert engine._kept is kept
    assert metrics.counter("bullion.serve.decode_eager_steps").value == \
        eager + 21
    fresh = ServeEngine(model, max_seq=24, device="cpu")
    assert np.array_equal(a, fresh.generate(first, 9)["tokens"])
    fresh = ServeEngine(model, max_seq=24, device="cpu")
    assert np.array_equal(b, fresh.generate(second, 12)["tokens"])
    ref = fresh._kept
    for (si, bj, n, x), (_, _, _, y) in zip(_tensors(kept.cache),
                                           _tensors(ref.cache)):
        assert torch.equal(x, y), (si, bj, n)
    assert int(kept.cache["pos"]) == 5 + 12
    assert kept.graph is None
    engine.generate(second[:1], 3)
    assert engine._kept is not kept and engine._kept.B == 1


@pytest.mark.parametrize("arch,capturable", [
    ("llama3_2_1b", True), ("gemma3_12b", True), ("starcoder2_15b", True),
    ("mixtral_8x22b", True), ("deepseek_moe_16b", True),
    ("chameleon_34b", True), ("minicpm3_4b", False), ("rwkv6_7b", False),
    ("recurrentgemma_9b", False), ("whisper_base", False)])
def test_families_with_host_state_keep_the_host_position(arch, capturable):
    """Every family's cache holds its position on the device, a 0-d int64
    tensor; the engine keeps a cache exactly where the decode step can be
    captured (not MLA, RWKV, RG-LRU or the encoder-decoder)."""
    model = tzoo.build(tconfigs.get_smoke(arch), device="cpu")
    assert model.capturable_decode is capturable
    pos = model.init_cache(1, 8)["pos"]
    assert pos.shape == () and pos.dtype == torch.int64
    assert pos.device == model.device and int(pos) == 0
    if model.is_encdec:
        return
    engine = ServeEngine(model, max_seq=12, device="cpu")
    engine.generate(np.zeros((1, 4), np.int32), 2)
    assert (engine._kept is not None) is capturable


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_capturable_decode_leaves_out_a_syncing_moe(case, dtype):
    """Every attention-and-MLP decoder can be captured but a dropless MoE
    computing in float32, whose grouped path reads the groups' ends on
    the host (``moe.syncs``)."""
    from repro_torch.models import moe
    arch, scaled = CASES[case]
    model = _capturable_model(arch, dtype, **scaled)
    syncs = case == "moe_grouped" and dtype == "float32"
    if case.startswith("moe"):
        assert moe.syncs(model.cfg) is syncs
    assert model.capturable_decode is not syncs
