"""The port's model stack on the CPU, held against the JAX package: layers,
the weight carrier, configs, and the smoke llama's prefill and decode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.config as jconfig
from repro.models import layers as jl
from repro.models import zoo as jzoo
import repro_torch.configs as tconfigs
import repro_torch.models.config as tconfig
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from repro_torch.models import zoo as tzoo
from repro_torch.models.base import P, init_tree, param_count
from repro_torch.models.convert import jax_leaves, load_jax_params

TOL = 2e-5   # one f32 layer, sums in another order


def _rng(seed=0):
    return np.random.default_rng(seed)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


def _jax_init(decl, seed=0):
    from repro.models.base import init_tree as jax_init_tree
    return jax.tree.map(np.asarray, jax_init_tree(decl, jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rmsnorm():
    rng = _rng(1)
    x, scale = _normal(rng, 2, 5, 32), _normal(rng, 32)
    ref = jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    out = tl.rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x))
    assert _err(out, ref) < TOL


@pytest.mark.parametrize("start,theta", [(0, 1e4), (37, 5e5)])
def test_rope(start, theta):
    x = _normal(_rng(2), 2, 7, 3, 16)
    pos = np.arange(start, start + 7, dtype=np.int32)
    ref = jl.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out = tl.rope(torch.tensor(x), torch.tensor(pos), theta)
    assert _err(out, ref) < 1e-4 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,causal,window,valid", [
    (2, 9, 9, 4, 2, True, 0, False),      # prefill, GQA
    (1, 9, 9, 4, 4, False, 0, False),     # MHA, not causal
    (2, 12, 12, 6, 2, True, 5, False),    # window
    (2, 1, 16, 4, 2, True, 0, True),      # decode: one query, kv_valid
    (3, 1, 10, 8, 1, True, 0, True),      # decode, MQA
])
def test_dot_attention(B, Sq, Skv, H, Hkv, causal, window, valid):
    rng = _rng(3)
    q, k, v = (_normal(rng, B, Sq, H, 8), _normal(rng, B, Skv, Hkv, 8),
               _normal(rng, B, Skv, Hkv, 8))
    kv_pos = np.arange(Skv, dtype=np.int32)
    q_pos = kv_pos[-Sq:] if Sq < Skv else kv_pos
    if valid:
        q_pos = np.array([6], np.int32)
        kv_valid = np.broadcast_to(kv_pos <= 6, (B, Skv))
    ref = jl.dot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(q_pos), jnp.asarray(kv_pos),
                           causal=causal, window=window,
                           kv_valid=jnp.asarray(kv_valid) if valid else None)
    out = tl.dot_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           torch.tensor(q_pos), torch.tensor(kv_pos),
                           causal=causal, window=window,
                           kv_valid=torch.tensor(kv_valid) if valid else None)
    assert out.shape == (B, Sq, H, 8)
    assert _err(out, ref) < TOL


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attn_qkv_and_out(fused, qk_norm):
    d, H, Hkv, D = 32, 4, 2, 8
    decl = jl.attention_decl(d, H, Hkv, D, qk_norm=qk_norm, fused=fused)
    params = _jax_init(decl, seed=4)
    x = _normal(_rng(5), 2, 6, d)
    pos = np.arange(6, dtype=np.int32)
    kw = dict(rope_theta=5e5, qk_norm=qk_norm, n_heads=H, n_kv=Hkv, head_dim=D)
    ref = jl.attn_qkv(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                      jnp.asarray(pos), **kw)
    tp = _torch_tree(params)
    out = tl.attn_qkv(tp, torch.tensor(x), torch.tensor(pos), **kw)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert _err(o, r) < 1e-4
    o_ref = jl.attn_out(jax.tree.map(jnp.asarray, params), ref[0])
    o_out = tl.attn_out(tp, out[0])
    assert _err(o_out, o_ref) < 1e-4


def test_swiglu():
    params = _jax_init(jl.swiglu_decl(32, 64), seed=6)
    x = _normal(_rng(7), 2, 5, 32)
    ref = jl.swiglu(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    out = tl.swiglu(_torch_tree(params), torch.tensor(x))
    assert _err(out, ref) < TOL


def test_init_tree_scheme():
    decl = {"embed": P((512, 64), ("vocab", "embed"), init="embed", scale=0.02),
            "w": P((64, 32, 16), ("embed", "heads", None)),   # fan_in = 32
            "ones": P((64,), (None,), init="ones"),
            "zeros": P((8, 8), (None, None), init="zeros")}
    gen = torch.Generator().manual_seed(0)
    tree = init_tree(decl, gen, "cpu")
    assert tree["embed"].std().item() == pytest.approx(0.02, rel=0.05)
    assert tree["w"].std().item() == pytest.approx(32 ** -0.5, rel=0.05)
    assert torch.equal(tree["ones"], torch.ones(64))
    assert torch.equal(tree["zeros"], torch.zeros(8, 8))
    again = init_tree(decl, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(tree[k], again[k]) for k in decl)
    assert param_count(decl) == 512 * 64 + 64 * 32 * 16 + 64 + 64


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_config_schema_matches_reference():
    for cls in ("ModelConfig", "MLAConfig", "EncoderConfig", "ShapeConfig"):
        ref = [(f.name, f.default) for f in dataclasses.fields(getattr(jconfig, cls))]
        got = [(f.name, f.default) for f in dataclasses.fields(getattr(tconfig, cls))]
        assert got == ref, cls
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}


@pytest.mark.parametrize("name", ["llama3.2-1b", "llama3_2_1b", "llama3-2-1b"])
def test_llama_config_matches_reference(name):
    assert dataclasses.asdict(tconfigs.get(name)) == \
        dataclasses.asdict(jconfigs.get(name))
    assert dataclasses.asdict(tconfigs.get_smoke(name)) == \
        dataclasses.asdict(jconfigs.get_smoke(name))


def test_every_reference_arch_is_ported():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for arch in jconfigs.ARCHS:
        assert tconfigs.get(arch).name == jconfigs.get(arch).name


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        tconfigs.get("no-such-model")


@pytest.mark.parametrize("block", ["ssm:swiglu", "full:relu", "rwkv:swiglu"])
def test_unknown_block_raises(block):
    """Every decoder block kind is ported; an unknown attention or MLP
    kind (or an MLP beside RWKV's own channel mix) raises ValueError."""
    cfg = tconfigs.get_smoke("llama3.2-1b")
    with pytest.raises(ValueError, match="unknown block"):
        ttf.block_decl(cfg, block)
    with pytest.raises(ValueError, match="unknown block"):
        ttf.init_cache(cfg.scaled(segments=(((block,), 1),)), 1, 8)


# ---------------------------------------------------------------------------
# weight carrier and the whole model
# ---------------------------------------------------------------------------


def _smoke():
    jcfg = jconfigs.get_smoke("llama3.2-1b").scaled(compute_dtype="float32")
    tcfg = tconfigs.get_smoke("llama3.2-1b").scaled(compute_dtype="float32")
    jm = jzoo.build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = tzoo.build(tcfg, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jcfg, jm, params, tm


def test_load_jax_params_roundtrips_every_leaf():
    _, jm, params, tm = _smoke()
    src = jax_leaves(jax.tree.map(np.asarray, params))
    got = dict(tm.named_parameters())
    assert set(got) == set(src)
    assert "segments.0.b0.1.attn.wq" in got
    for name, arr in src.items():
        assert np.array_equal(got[name].numpy(), arr), name
    assert tm.n_params == jm.n_params == sum(p.numel() for p in got.values())


def _mutate(tree, how):
    tree = jax.tree.map(lambda a: a, tree)
    if how == "missing":
        del tree["final_norm"]
    elif how == "extra":
        tree["bogus"] = np.zeros(3, np.float32)
    elif how == "shape":
        tree["embed"] = tree["embed"].T
    elif how == "layers":
        wq = tree["segments"][0]["b0"]["attn"]["wq"]
        tree["segments"][0]["b0"]["attn"]["wq"] = np.concatenate([wq, wq[:1]])
    return tree


@pytest.mark.parametrize("how", ["missing", "extra", "shape", "layers"])
def test_load_jax_params_raises(how):
    _, _, params, tm = _smoke()
    tree = _mutate(jax.tree.map(np.asarray, params), how)
    with pytest.raises(ValueError):
        load_jax_params(tm, tree)


# the decode configs: a full-attention model; local and global layers
# decoded past their window of 8; the MoE capacity path; the dropless
# grouped path (capacity factor E / k), windowed
DECODE = {
    "full": ("llama3_2_1b", {}),
    "window": ("gemma3_12b", {}),
    "moe_capacity": ("deepseek_moe_16b", {}),
    "moe_grouped": ("mixtral_8x22b", {"n_experts": 8, "capacity_factor": 4.0}),
}
# the relative nudge of every parameter that stands for one rounding at the
# compute dtype: half an ulp at 1.0 (tests/test_torch_distributed.py nudges
# f32 by 2**-24)
NUDGE = {"float32": 0.0, "bfloat16": 2.0 ** -8}


def _reference_decode(jm, params, tok, P_, max_seq):
    """The reference's prefill of ``tok[:, :P_]`` and teacher-forced decode
    steps over the rest: (the logits of every call, every cache tensor
    after the last by (segment, block, name)), as f32 NumPy."""
    cache = jm.init_cache(tok.shape[0], max_seq, dtype=jnp.float32)
    ref, cache = jm.prefill(params, {"tokens": jnp.asarray(tok[:, :P_])},
                            cache)
    logits, dec = [ref], jax.jit(jm.decode_step)
    for i in range(P_, tok.shape[1]):
        ref, cache = dec(params, cache, jnp.asarray(tok[:, i:i + 1]))
        logits.append(ref)
    assert int(cache["pos"]) == tok.shape[1]
    return ([np.asarray(x, np.float32) for x in logits],
            {(si, bj, n): np.asarray(t, np.float32)
             for si, seg in enumerate(cache["segments"])
             for bj, c in seg.items() for n, t in c.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(DECODE))
def test_smoke_prefill_and_decode_match_jax(case, dtype):
    """Prefill logits and 10 teacher-forced decode steps at the cache's
    position on the device (RoPE, the cache write at ``pos`` or
    ``pos % S``, the valid slots), computing in ``dtype`` on the JAX
    package's weights: every call's logits, the position, and every cache
    tensor after the last, against the reference's. Each within 1e-4 of
    its scale + 1e-5 (f32 sums in another order) or, in bf16, twice the
    reference's own move when each of its parameters is nudged by
    ``NUDGE`` (a bf16 rounding can flip a near-tied expert choice) where
    larger."""
    arch, scaled = DECODE[case]
    jcfg = jconfigs.get_smoke(arch).scaled(compute_dtype=dtype, **scaled)
    jm = jzoo.build(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = tzoo.build(tconfigs.get_smoke(arch).scaled(compute_dtype=dtype,
                                                    **scaled), device="cpu")
    load_jax_params(tm, params)
    B, P_, steps, max_seq = 2, 12, 10, 24
    tok = _rng(8).integers(0, jcfg.vocab, (B, P_ + steps)).astype(np.int32)
    want, want_cache = _reference_decode(jm, params, tok, P_, max_seq)
    rng = _rng(0)
    nudged = jax.tree.map(lambda p: (p * (1 + rng.choice(
        [-1.0, 1.0], p.shape) * NUDGE[dtype])).astype(np.float32), params)
    moved, moved_cache = _reference_decode(jm, nudged, tok, P_, max_seq) \
        if NUDGE[dtype] else (want, want_cache)
    tcache = tm.init_cache(B, max_seq, dtype=torch.float32)
    with torch.inference_mode():
        got, tcache = tm.prefill({"tokens": torch.tensor(tok[:, :P_]).long()},
                                 tcache)
        got = [got]
        for i in range(P_, P_ + steps):
            out, tcache = tm.decode_step(tcache,
                                         torch.tensor(tok[:, i:i + 1]).long())
            got.append(out)
    scale = float(np.abs(want[0]).max())
    for i, (a, b, m) in enumerate(zip(got, want, moved)):
        assert _err(a.float(), b) < max(1e-4 * scale + 1e-5,
                                        2 * _err(m, b)), i
    assert tcache["pos"].shape == () and int(tcache["pos"]) == P_ + steps
    for (si, bj, n), b in want_cache.items():
        a = tcache["segments"][si][bj][n]
        assert _err(a, b) < max(1e-4 * float(np.abs(b).max()) + 1e-5,
                                2 * _err(moved_cache[si, bj, n], b)), \
            (si, bj, n)


def test_decode_equals_full_forward():
    """The reference's own check (tests/test_serving_caches.py) on the port."""
    cfg, _, _, tm = _smoke()
    B, P_, total = 1, 4, 14
    tok = torch.tensor(_rng(9).integers(0, cfg.vocab, (B, total)))
    with torch.inference_mode():
        ctx = ttf.Ctx(cfg=tm.cfg, mode="prefill", positions=torch.arange(total))
        x, _ = ttf.forward(tm, ttf.embed_tokens(tm, tok, tm.cfg,
                                                torch.float32), tm.cfg, ctx)
        ref = ttf.logits_fn(tm, x, tm.cfg)
        scale = float(ref.abs().max()) + 1e-6
        lg, cache = tm.prefill({"tokens": tok[:, :P_]},
                               tm.init_cache(B, total, dtype=torch.float32))
        assert float((lg - ref[:, P_ - 1]).abs().max()) < 2e-3 * scale + 1e-4
        for i in range(total - P_ - 1):
            lg, cache = tm.decode_step(cache, tok[:, P_ + i:P_ + i + 1])
            err = float((lg - ref[:, P_ + i]).abs().max())
            assert err < 2e-3 * scale + 1e-4, i


def test_cache_overflow_and_training_mode_raise():
    _, _, _, tm = _smoke()
    tok = torch.zeros(1, 4, dtype=torch.long)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="exceeds"):
            tm.prefill({"tokens": tok}, tm.init_cache(1, 3))
        _, cache = tm.prefill({"tokens": tok}, tm.init_cache(1, 4))
        with pytest.raises(ValueError, match="full"):
            tm.decode_step(cache, tok[:, :1])
        # training runs (tests/test_torch_train.py), but takes no cache
        with pytest.raises(ValueError, match="no cache"):
            ttf.forward(tm, torch.zeros(1, 2, tm.cfg.d_model), tm.cfg,
                        ttf.Ctx(cfg=tm.cfg, mode="train",
                                positions=torch.arange(2)), cache=cache)
        with pytest.raises(ValueError, match="unknown mode"):
            ttf.forward(tm, torch.zeros(1, 2, tm.cfg.d_model), tm.cfg,
                        ttf.Ctx(cfg=tm.cfg, mode="score",
                                positions=torch.arange(2)))
