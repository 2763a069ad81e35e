"""The attention block families of the port on the CPU, held against the
JAX package: LayerNorm and the GELU MLP, windowed attention with rolling
caches, the MoE block inside a model, the capacity rule of the caches, and
the five configurations that need them (gemma3-12b, starcoder2-15b,
chameleon-34b, deepseek-moe-16b, mixtral-8x22b) at their smoke sizes.

Parameters are initialised by the JAX package and carried across with
``load_jax_params``; tokens come from a numpy seed; everything is f32."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.configs as jconfigs
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro.models import zoo as jzoo
from repro.serve import ServeEngine as JaxServeEngine
import repro_torch.configs as tconfigs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from repro_torch.models import zoo as tzoo
from repro_torch.models.base import param_count
from repro_torch.models.convert import jax_leaves, load_jax_params, stack_leaves
from repro_torch.serve import ServeEngine

FAMILIES = ("gemma3_12b", "starcoder2_15b", "chameleon_34b",
            "deepseek_moe_16b", "mixtral_8x22b")
WINDOWED = ("gemma3_12b", "mixtral_8x22b")
MOE = ("deepseek_moe_16b", "mixtral_8x22b")
LOSS_TOL = 1e-5        # tests/test_torch_train.py
GRAD_TOL = 5e-5


def _tol(scale: float) -> float:
    """Logits of a smoke model, f32, sums in another order."""
    return 1e-4 * scale + 1e-5


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _cfgs(arch, **kw):
    return (jconfigs.get_smoke(arch).scaled(compute_dtype="float32", **kw),
            tconfigs.get_smoke(arch).scaled(compute_dtype="float32", **kw))


@functools.lru_cache(maxsize=None)
def _jax_model(arch, **kw):
    jcfg, _ = _cfgs(arch, **kw)
    jm = jzoo.build(jcfg)
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _pair(arch, **kw):
    """(reference model, its params as numpy, the port's model on them)."""
    jm, params = _jax_model(arch, **kw)
    tm = tzoo.build(_cfgs(arch, **kw)[1], device="cpu")
    load_jax_params(tm, params)
    return jm, params, tm


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=48).astype(np.float32),
         "bias": rng.normal(size=48).astype(np.float32)}
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ref = jl.layernorm(jax.tree.map(jnp.asarray, p), jx)
    tx = torch.tensor(x).to(torch.bfloat16 if dtype == "bfloat16"
                            else torch.float32)
    out = tl.layernorm({k: torch.tensor(v) for k, v in p.items()}, tx)
    assert out.dtype == tx.dtype
    tol = 2e-5 if dtype == np.float32 else 2 ** -7 * float(np.abs(
        np.asarray(ref, np.float32)).max())
    assert _err(out.float(), np.asarray(ref, np.float32)) <= tol


def test_gelu_mlp_matches_reference_tanh_gelu():
    """The reference's ``jax.nn.gelu`` is the tanh approximation: the port
    agrees within 2e-6, ten times closer than the erf form would."""
    decl = jl.gelu_mlp_decl(32, 64)
    from repro.models.base import init_tree as jax_init_tree
    params = jax.tree.map(np.asarray, jax_init_tree(decl,
                                                    jax.random.PRNGKey(2)))
    params["b_up"] = np.random.default_rng(3).normal(size=64).astype(
        np.float32)
    params["b_down"] = np.random.default_rng(4).normal(size=32).astype(
        np.float32)
    x = np.random.default_rng(5).normal(size=(2, 5, 32)).astype(np.float32)
    ref = jl.gelu_mlp(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.tensor(v) for k, v in params.items()}
    out = tl.gelu_mlp(tp, torch.tensor(x))
    assert _err(out, ref) < 2e-6
    h = torch.tensor(x) @ tp["w_up"] + tp["b_up"]
    erf = torch.nn.functional.gelu(h) @ tp["w_down"] + tp["b_down"]
    assert _err(erf, ref) > 10 * 2e-6


# ---------------------------------------------------------------------------
# configs, declarations and the weight carrier
# ---------------------------------------------------------------------------


def _names(arch):
    return sorted({arch, arch.replace("_", "-"),
                   jconfigs.get(arch).name})


@pytest.mark.parametrize("name", [n for a in tconfigs.PORTED
                                  for n in _names(a)])
def test_config_matches_reference(name):
    assert dataclasses.asdict(tconfigs.get(name)) == \
        dataclasses.asdict(jconfigs.get(name))
    assert dataclasses.asdict(tconfigs.get_smoke(name)) == \
        dataclasses.asdict(jconfigs.get_smoke(name))


@pytest.mark.parametrize("arch", tconfigs.PORTED)
def test_param_counts_full_configs(arch):
    """The full configs declare the reference's parameters, leaf for leaf
    (declarations only: nothing is allocated)."""
    jm = jzoo.build(jconfigs.get(arch))
    tdecl = ttf.model_decl(tconfigs.get(arch))
    assert param_count(tdecl) == jm.n_params
    assert _unstacked_shapes(jm.decl) == \
        {k: v.shape for k, v in _port_decl_leaves(tdecl).items()}


def _unstacked_shapes(jdecl):
    """The reference's declaration as {port parameter name: shape}."""
    from repro.models.base import is_decl
    out = {}
    for path, p in jax.tree_util.tree_flatten_with_path(
            jdecl, is_leaf=is_decl)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[0] == "segments":
            for i in range(p.shape[0]):
                out[".".join(keys[:3] + [str(i)] + keys[3:])] = p.shape[1:]
        else:
            out[".".join(keys)] = p.shape
    return out


def _port_decl_leaves(tdecl, prefix=""):
    out = {}
    items = tdecl.items() if isinstance(tdecl, dict) else enumerate(tdecl)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_port_decl_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_load_jax_params_carries_the_new_leaves(arch):
    """LayerNorm ``bias``, the GELU MLP's biases, the MoE router, expert
    chunks and shared experts cross unchanged, and ``stack_leaves`` gives
    the reference's tree back."""
    jm, params, tm = _pair(arch)
    src = jax_leaves(params)
    got = dict(tm.named_parameters())
    assert set(got) == set(src)
    for name, arr in src.items():
        assert np.array_equal(got[name].numpy(), arr), name
    assert tm.n_params == jm.n_params
    want = {"starcoder2_15b": ["segments.0.b0.0.ln_attn.bias",
                               "segments.0.b0.1.mlp.b_up",
                               "segments.0.b0.1.mlp.b_down",
                               "final_norm.bias"],
            "deepseek_moe_16b": ["segments.1.b0.1.moe.router",
                                 "segments.1.b0.0.moe.wg",
                                 "segments.1.b0.0.moe.shared.w_gate",
                                 "segments.0.b0.0.mlp.w_gate"],
            "mixtral_8x22b": ["segments.0.b0.1.moe.wd"],
            "gemma3_12b": ["segments.0.b2.1.attn.q_norm.scale"],
            "chameleon_34b": ["segments.0.b0.1.attn.k_norm.scale"]}[arch]
    assert set(want) <= set(got)
    back = stack_leaves(got)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat_a, flat_b))


# ---------------------------------------------------------------------------
# serving: prefill, decode, rolling caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_jax(arch):
    """Prefill logits, 8 teacher-forced decode steps and every cache (the
    rolling ones included) against the reference; for the windowed
    configs the prompt (12) is past the smoke window (8)."""
    check_prefill_and_decode(arch)


def check_prefill_and_decode(arch, P_=12, **kw):
    """Prefill of P_ tokens, 8 teacher-forced decode steps and every
    tensor of every layer's cache against the reference (config fields
    ``kw`` set in both), the logits within ``_tol`` of their scale, each
    cache tensor within ``_tol`` of its own."""
    jm, params, tm = _pair(arch, **kw)
    cfg = tm.cfg
    B, steps = 2, 8
    max_seq = P_ + 12
    tok = _tokens(cfg.vocab, (B, P_ + steps), 8)
    jcache = jm.init_cache(B, max_seq, dtype=jnp.float32)
    tcache = tm.init_cache(B, max_seq, dtype=torch.float32)
    ref, jcache = jm.prefill(params, {"tokens": jnp.asarray(tok[:, :P_])},
                             jcache)
    with torch.inference_mode():
        out, tcache = tm.prefill({"tokens": torch.tensor(tok[:, :P_]).long()},
                                 tcache)
    scale = float(np.abs(np.asarray(ref)).max())
    assert _err(out, ref) < _tol(scale)
    dec = jax.jit(jm.decode_step)
    for i in range(steps):
        t = tok[:, P_ + i:P_ + i + 1]
        ref, jcache = dec(params, jcache, jnp.asarray(t))
        with torch.inference_mode():
            out, tcache = tm.decode_step(tcache, torch.tensor(t).long())
        assert _err(out, ref) < _tol(scale), i
    assert tcache["pos"] == int(jcache["pos"]) == P_ + steps
    for si, seg in enumerate(jcache["segments"]):
        for bj, c in seg.items():
            assert set(tcache["segments"][si][bj]) == set(c), (si, bj)
            for n in c:
                ref_c = np.asarray(c[n])
                got = tcache["segments"][si][bj][n]
                assert tuple(got.shape) == ref_c.shape, (si, bj, n)
                assert got.dtype == torch.float32, (si, bj, n)
                assert _err(got, ref_c) < _tol(
                    float(np.abs(ref_c).max())), (si, bj, n)


def _full_logits(tm, tok):
    ctx = ttf.Ctx(cfg=tm.cfg, mode="prefill",
                  positions=torch.arange(tok.shape[1]))
    x, _ = ttf.forward(tm, ttf.embed_tokens(tm, tok, tm.cfg, torch.float32),
                       tm.cfg, ctx)
    return ttf.logits_fn(tm, x, tm.cfg)


def _decode_against_full(arch, kw, B, P_, total, extra, tol):
    """The reference's invariant on the port (decode steps equal the full
    forward's logits) and the port's decode steps against the reference's
    decode steps on the same weights and tokens."""
    jm, params, tm = _pair(arch, **kw)
    tok = _tokens(tm.cfg.vocab, (B, total), 9)
    dec = jax.jit(jm.decode_step)
    jcache = jm.init_cache(B, total, dtype=jnp.float32)
    jlg, jcache = jm.prefill(params, {"tokens": jnp.asarray(tok[:, :P_])},
                             jcache)
    with torch.inference_mode():
        ttok = torch.tensor(tok).long()
        ref = _full_logits(tm, ttok)
        scale = float(ref.abs().max()) + 1e-6
        lg, cache = tm.prefill({"tokens": ttok[:, :P_]},
                               tm.init_cache(B, total, dtype=torch.float32))
        assert float((lg - ref[:, P_ - 1]).abs().max()) < tol(scale)
        assert _err(lg, jlg) < _tol(scale)
        for i in range(extra):
            lg, cache = tm.decode_step(cache, ttok[:, P_ + i:P_ + i + 1])
            jlg, jcache = dec(params, jcache, jnp.asarray(tok[:, P_ + i:P_ + i + 1]))
            assert float((lg - ref[:, P_ + i]).abs().max()) < tol(scale), i
            assert _err(lg, jlg) < _tol(scale), i


@pytest.mark.parametrize("arch", WINDOWED)
def test_long_decode_past_window(arch):
    """Mirror of tests/test_serving_caches.py's: 3x past a window of 6."""
    _decode_against_full(arch, dict(capacity_factor=32.0, window=6), B=1,
                         P_=4, total=22, extra=17,
                         tol=lambda s: 2e-3 * s + 1e-4)


def test_prefill_longer_than_window_fills_rolling_buffer():
    """Mirror of tests/test_serving_caches.py's: a prompt of 11 rolled into
    a window of 4, then two decode steps."""
    _decode_against_full("mixtral_8x22b", dict(capacity_factor=32.0,
                                               window=4),
                         B=1, P_=11, total=14, extra=2,
                         tol=lambda s: 2e-3 * s + 1e-4)


def test_windowed_cache_rolls():
    """Mirror of tests/test_arch_smoke.py's: decode well past a window of
    8 from a prompt of 6."""
    _decode_against_full("mixtral_8x22b", dict(capacity_factor=16.0,
                                               window=8),
                         B=1, P_=6, total=14, extra=7,
                         tol=lambda s: 1e-3 * s + 1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_full_forward(arch):
    """Mirror of tests/test_arch_smoke.py's, on the port alone."""
    check_decode_matches_full_forward(arch)


def check_decode_matches_full_forward(arch):
    _, _, tm = _pair(arch, capacity_factor=16.0)
    B, S = 2, 12
    tok = torch.tensor(_tokens(tm.cfg.vocab, (B, S + 2), 10)).long()
    with torch.inference_mode():
        ref = _full_logits(tm, tok)
        scale = float(ref.abs().max()) + 1e-6
        lg, cache = tm.prefill({"tokens": tok[:, :S]},
                               tm.init_cache(B, S + 4, dtype=torch.float32))
        assert float((lg - ref[:, S - 1]).abs().max()) < 1e-3 * scale + 1e-4
        for i in range(2):
            lg, cache = tm.decode_step(cache, tok[:, S + i:S + i + 1])
            assert float((lg - ref[:, S + i]).abs().max()) < \
                1e-3 * scale + 1e-4, i


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 64))
def test_rolling_pos_invariants(pos, W):
    """Slot i holds the latest position p <= pos with p % W == i (negative:
    not written yet); equal to the reference's."""
    kv_pos = ttf._rolling_pos(pos, W).numpy()
    assert np.array_equal(kv_pos, np.asarray(jtf._rolling_pos(
        jnp.asarray(pos), W)))
    for i, p in enumerate(kv_pos):
        assert p % W == i or p < 0
        assert p <= pos
        assert p + W > pos


def test_prefill_passes_each_block_its_window(monkeypatch):
    """Every prefill attention goes to the flash-attention wrapper with its
    block's window: the local blocks' for gemma3, none for global."""
    _, _, tm = _pair("gemma3_12b")
    seen = []
    attn = ttf.attention
    monkeypatch.setattr(ttf, "attention", lambda *a, **kw: seen.append(
        kw["window"]) or attn(*a, **kw))
    with torch.inference_mode():
        tm.prefill({"tokens": torch.zeros((1, 10), dtype=torch.long)},
                   tm.init_cache(1, 16, dtype=torch.float32))
    W = tm.cfg.window
    assert seen == [W, W, 0, W, W, 0]


def test_cache_slots_and_capacity():
    """Windowed caches hold min(window, seq_len) slots and never fill; the
    full/global caches set the capacity (not block 0, which is local in
    gemma3); a model with no full/global block decodes past seq_len."""
    _, _, gemma = _pair("gemma3_12b")
    cache = gemma.init_cache(1, 20, dtype=torch.float32)
    assert [c["k"].shape[2] for c in cache["segments"][0].values()] == \
        [8, 8, 20]
    assert ttf.cache_capacity(gemma.cfg, cache) == 20
    tok = torch.zeros((1, 21), dtype=torch.long)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="exceeds"):
            gemma.prefill({"tokens": tok}, cache)
        _, cache = gemma.prefill({"tokens": tok[:, :20]}, cache)  # 20 > 8
        with pytest.raises(ValueError, match="full"):
            gemma.decode_step(cache, tok[:, :1])
    _, _, mixtral = _pair("mixtral_8x22b", capacity_factor=16.0)
    cache = mixtral.init_cache(1, 6, dtype=torch.float32)
    assert ttf.cache_capacity(mixtral.cfg, cache) is None
    with torch.inference_mode():
        lg, cache = mixtral.prefill({"tokens": tok[:, :9]}, cache)
        for _ in range(4):
            lg, cache = mixtral.decode_step(cache, lg.argmax(-1)[:, None])
    assert cache["pos"] == 13 and bool(torch.isfinite(lg).all())


@pytest.mark.parametrize("arch", WINDOWED + MOE[:1])
def test_generate_matches_jax_engine(arch):
    """``ServeEngine.generate`` with rolling caches and MoE blocks: greedy
    tokens equal to the reference engine's, past the window."""
    check_generate(arch)


def check_generate(arch):
    jm, params, tm = _pair(arch, capacity_factor=16.0)
    prompts = _tokens(tm.cfg.vocab, (2, 10), 11)
    ref = JaxServeEngine(jm, jax.tree.map(jnp.asarray, params),
                         max_seq=24).generate(prompts, max_new_tokens=10)
    out = ServeEngine(tm, max_seq=24, device="cpu").generate(
        prompts, max_new_tokens=10)
    assert np.array_equal(out["tokens"], ref["tokens"])


@pytest.mark.parametrize("arch", ["gemma3_12b", "starcoder2_15b",
                                  "deepseek_moe_16b"])
def test_generate_bf16_compute_on_cpu(arch):
    """The serving path at bf16 compute (the card's type) runs end to end
    for the new block families."""
    cfg = tconfigs.get_smoke(arch)
    eng = ServeEngine(tzoo.build(cfg, device="cpu", dtype=torch.bfloat16),
                      max_seq=32, device="cpu")
    out = eng.generate(np.arange(24, dtype=np.int32).reshape(2, 12), 6)
    assert out["tokens"].shape == (2, 6)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab)).all()


# ---------------------------------------------------------------------------
# training: the loss with the MoE aux, gradients, the launcher
# ---------------------------------------------------------------------------


def _batch(vocab, seed=1, B=2, S=16):
    return {"tokens": _tokens(vocab, (B, S + 1), seed)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches_reference(arch):
    check_loss(arch)


def check_loss(arch):
    jm, params, tm = _pair(arch)
    batch = _batch(tm.cfg.vocab)
    want = float(jm.loss(params, {"tokens": jnp.asarray(batch["tokens"])}))
    with torch.no_grad():
        got = float(tm.loss(batch))
    assert abs(got - want) < LOSS_TOL, (got, want)


@pytest.mark.parametrize("arch", MOE)
def test_loss_adds_the_moe_aux(arch):
    """The blocks' aux losses, summed by ``forward``, equal the
    reference's; the loss is the cross-entropy plus aux_loss_weight times
    that sum."""
    jm, params, tm = _pair(arch)
    cfg = tm.cfg
    tokens = _batch(cfg.vocab, seed=3)["tokens"]
    T = tokens.shape[1] - 1
    jctx = jtf.Ctx(cfg=jm.cfg, mode="train",
                   positions=jnp.arange(T, dtype=jnp.int32))
    jx = jtf.embed_tokens(params, jnp.asarray(tokens[:, :-1]), jm.cfg,
                          jnp.float32)
    _, _, jaux = jtf.forward(params, jx, jm.cfg, jctx)
    with torch.no_grad():
        ctx = ttf.Ctx(cfg=cfg, mode="train", positions=torch.arange(T))
        x = ttf.embed_tokens(tm, torch.tensor(tokens[:, :-1]).long(), cfg,
                             torch.float32)
        h, aux = ttf.forward(tm, x, cfg, ctx)
        xent = tzoo._xent(ttf.logits_fn(tm, h, cfg),
                          torch.tensor(tokens[:, 1:]).long())
        loss = tm.loss({"tokens": tokens})
    n_moe = sum(rep for blocks, rep in cfg.segments for b in blocks
                if b.endswith(":moe"))
    assert n_moe >= 2 and float(aux) > 0.5 * n_moe
    assert abs(float(aux) - float(jaux)) < 1e-5 * n_moe
    assert abs(float(loss) - float(xent + cfg.aux_loss_weight * aux)) < 1e-6


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_gradient_matches_reference(arch):
    """``jax.value_and_grad`` of the reference's loss against the port's
    loss and ``torch.autograd.grad``, at test_torch_train.py's tolerances:
    each leaf within GRAD_TOL, or twice what one ulp of the reference's
    own parameters does to its gradient where that is larger."""
    check_gradients(arch)


def check_gradients(arch):
    jm, params, tm = _pair(arch)
    batch = {"tokens": jnp.asarray(_batch(tm.cfg.vocab, seed=2)["tokens"])}
    vg = jax.value_and_grad(jm.loss)

    def grad(p):
        loss, g = vg(p, batch)
        return float(loss), jax_leaves(jax.tree.map(np.asarray, g))

    want_loss, want = grad(params)
    rng = np.random.default_rng(0)
    _, nudged = grad(jax.tree.map(lambda p: (p * (1 + rng.choice(
        [-1.0, 1.0], p.shape) * 2.0**-24)).astype(np.float32), params))
    tm.requires_grad_(True)
    loss = tm.loss({"tokens": np.asarray(batch["tokens"])})
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    got = {n: g.numpy() for n, g in zip(names, grads)}
    assert abs(float(loss.detach()) - want_loss) < LOSS_TOL
    assert got.keys() == want.keys()
    for k in want:
        tol = max(GRAD_TOL, 2 * float(np.abs(nudged[k] - want[k]).max()))
        assert float(np.abs(got[k] - want[k]).max()) <= tol, k


@pytest.mark.parametrize("arch", ["gemma3-12b", "deepseek-moe-16b"])
def test_train_launcher_smoke(arch, tmp_path):
    """``launch.train --arch <arch> --smoke`` on the CPU: finite losses,
    windowed attention and MoE blocks under rematerialisation."""
    from repro_torch.launch.train import main
    losses = main(["--arch", arch, "--smoke", "--steps", "3", "--batch", "2",
                   "--seq", "32", "--data", str(tmp_path / "d"), "--ckpt",
                   str(tmp_path / "ck"), "--ckpt-every", "3",
                   "--log-every", "3", "--device", "cpu"])
    assert len(losses) == 3 and all(np.isfinite(x) for x in losses)


def test_no_launch_on_the_cpu():
    """The CPU takes the plain version: the model's prefill counts no
    launch of the kernel, windowed or not."""
    _, _, tm = _pair("gemma3_12b")
    before = (flash_attention.launches,
              dict(flash_attention.launches_by_window))
    with torch.inference_mode():
        tm.prefill({"tokens": torch.zeros((1, 10), dtype=torch.long)},
                   tm.init_cache(1, 16, dtype=torch.float32))
    assert (flash_attention.launches,
            flash_attention.launches_by_window) == before
