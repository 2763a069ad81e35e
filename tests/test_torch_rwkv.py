"""The RWKV-6 block (``models/rwkv6.py``) and rwkv6-7b on the CPU, held
against the JAX package's ``repro.models.rwkv6`` and its smoke config.

WKV has the reference's two forms: ``wkv_scan`` (one step a token, f32)
and ``wkv_chunked`` (chunk-parallel products over chunks of 64, with the
reference's -60 clamps). Inputs come from a numpy seed; parameters are the
JAX package's, carried across with ``load_jax_params``; everything is f32.

Tolerances: ``wkv_scan``, ``wkv_chunked`` and the block within 1e-5 of
their scale plus 1e-6 of the reference's (f32, sums in another order);
``wkv_chunked`` against ``wkv_scan`` within 2e-3 on mild decays, as
``tests/test_arch_smoke.py::test_rwkv_chunked_matches_scan`` holds the
reference's two forms (past a chunk's e^-60 clamp they part); the model's
logits and caches as in ``tests/test_torch_families.py``; the loss within
1e-5 and every gradient within 5e-5 or twice what one ulp of the
reference's parameters does to it (``tests/test_torch_train.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import rwkv6 as jrw
from repro.models.base import init_tree as jax_init_tree
import repro_torch.configs as tconfigs
from repro_torch.models import rwkv6 as trw
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import jax_leaves, stack_leaves
from test_torch_families import (_err, _pair, check_decode_matches_full_forward,
                                 check_generate, check_gradients, check_loss,
                                 check_prefill_and_decode)

ARCH = "rwkv6_7b"


def _close(got, ref, rel=1e-5, abs_=1e-6) -> bool:
    ref = np.asarray(ref, np.float64)
    return _err(got, ref) <= rel * float(np.abs(ref).max()) + abs_


def _wkv_inputs(B, T, H, D, seed):
    """r, k, v, the decay w in (0, 1) (the block's exp(-exp(.)) of a
    normal), u and an initial state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(B, T, H, D)) - 0.5)).astype(
        np.float32)
    u = rng.normal(size=(H, D)).astype(np.float32)
    S = rng.normal(size=(B, H, D, D)).astype(np.float32) * 0.1
    return r, k, v, w, u, S


@pytest.mark.parametrize("T", [1, 5, 64])
def test_wkv_scan_matches_reference(T):
    args = _wkv_inputs(2, T, 3, 8, T)
    ry, rS = jrw.wkv_scan(*map(jnp.asarray, args))
    gy, gS = trw.wkv_scan(*map(torch.tensor, args))
    assert _close(gy, ry) and _close(gS, rS)


@pytest.mark.parametrize("T", [64, 192])
def test_wkv_chunked_matches_reference_and_scan(T):
    """Chunks of 64: against the reference's ``wkv_chunked`` on the same
    inputs; and against the port's ``wkv_scan`` on the mild decays of
    ``tests/test_arch_smoke.py::test_rwkv_chunked_matches_scan`` (within
    its 2e-3), where the cumulative decay of a chunk stays above e^-60."""
    args = _wkv_inputs(2, T, 3, 8, 100 + T)
    ry, rS = jrw.wkv_chunked(*map(jnp.asarray, args))
    gy, gS = trw.wkv_chunked(*map(torch.tensor, args))
    assert _close(gy, ry) and _close(gS, rS)
    rng = np.random.default_rng(T)
    r, k, v, _, u, S = args
    w = (1.0 / (1.0 + np.exp(-rng.normal(1.0, 0.5, r.shape)))).astype(
        np.float32)
    mild = [torch.tensor(a) for a in (r, k, v, w, u, S)]
    (sy, sS), (cy, cS) = trw.wkv_scan(*mild), trw.wkv_chunked(*mild)
    assert _err(cy, sy) < 2e-3 and _err(cS, sS) < 2e-3


def test_wkv_chunked_clamp_fault_is_the_reference_s():
    """Where a chunk's cumulative decay falls below e^-60 (decays under
    e^-0.94 a step, as the block's init gives: exp(-exp(0)) = 0.37), the
    -60 clamps break the chunked form: it leaves the loop over time far
    behind, in the reference as in the port, and the two packages'
    chunked forms still agree with each other (ROADMAP.md, faults of the
    reference)."""
    r, k, v, _, u, S = _wkv_inputs(1, 64, 2, 8, 3)
    w = np.full(r.shape, np.exp(-1.0), np.float32)
    ry, rS = jrw.wkv_chunked(*map(jnp.asarray, (r, k, v, w, u, S)))
    sy, sS = jrw.wkv_scan(*map(jnp.asarray, (r, k, v, w, u, S)))
    gy, gS = trw.wkv_chunked(*map(torch.tensor, (r, k, v, w, u, S)))
    assert _err(ry, sy) > 1.0 and _err(rS, sS) > 1.0
    assert _close(gy, ry) and _close(gS, rS)


def test_wkv_chunked_overflow_is_the_reference_s():
    """Past the clamp (the exclusive cumulative log-decay held at -60), a
    step with a log-decay under -(88.72 - 60) overflows f32 in the chunked
    form's ``k * exp(-ce - lw)``: from that step on the chunk's outputs
    are inf or NaN, in the reference as in the port and at the same
    entries, where the loop over time stays finite. This is how rwkv6-7b
    served through ``rwkv_chunked`` gets non-finite logits (ROADMAP.md,
    faults of the reference)."""
    r, k, v, _, u, S = _wkv_inputs(1, 64, 2, 8, 4)
    lw = np.full(r.shape, -2.0)
    lw[:, 40:] = -30.0              # the cumulative sum is past -60 by then
    w = np.exp(lw).astype(np.float32)
    args = (r, k, v, w, u, S)
    ry, rS = map(np.asarray, jrw.wkv_chunked(*map(jnp.asarray, args)))
    gy, gS = (t.numpy() for t in trw.wkv_chunked(*map(torch.tensor, args)))
    sy, _ = jrw.wkv_scan(*map(jnp.asarray, args))
    assert np.isfinite(np.asarray(sy)).all()
    bad = ~np.isfinite(ry)
    assert bad[:, 41:].any() and not bad[:, :41].any()
    assert np.array_equal(bad, ~np.isfinite(gy))
    assert _close(gy[~bad], ry[~bad])
    assert np.isfinite(rS).all() and _close(gS, rS)


def test_wkv_chunked_needs_whole_chunks():
    args = [torch.tensor(a) for a in _wkv_inputs(1, 65, 1, 4, 0)]
    with pytest.raises(ValueError, match="chunk"):
        trw.wkv_chunked(*args)


@pytest.fixture(scope="module", params=[False, True], ids=["split", "fused"])
def block(request):
    """The smoke config at f32 in one of the two projection forms
    (``fused_qkv``: the ``wrkvg`` weight), one block's parameters (the JAX
    package's init, with random mixes and decay biases so that every ddlerp
    and decay path is exercised) for both packages, and inputs
    x [2, 64, d]."""
    cfg = jconfigs.get_smoke(ARCH).scaled(compute_dtype="float32",
                                          fused_qkv=request.param)
    params = jax.tree.map(np.asarray, jax_init_tree(
        jrw.rwkv_decl(cfg), jax.random.PRNGKey(5)))
    rng = np.random.default_rng(0)
    for k in ("mu_x", "mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        params["tm"][k] = rng.uniform(-1, 1, params["tm"][k].shape).astype(
            np.float32)
    # decays of 0.6-0.9 a step: a chunk's cumulative decay stays above the
    # chunked form's e^-60 clamp
    params["tm"]["w0"] = rng.uniform(-3, -1.5, params["tm"]["w0"].shape
                                     ).astype(np.float32)
    for k in ("mu_k", "mu_r"):
        params["cm"][k] = rng.uniform(0, 1, params["cm"][k].shape).astype(
            np.float32)
    x = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    return cfg, params, jax.tree.map(torch.tensor, params), x


@pytest.mark.parametrize("use_chunked", [False, True])
def test_block_train_form_matches_reference(block, use_chunked):
    cfg, params, tp, x = block
    ref, _ = jrw.rwkv_block(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x), None, cfg=cfg,
                            use_chunked=use_chunked)
    got = trw.rwkv_block(tp, torch.tensor(x), None, cfg=cfg,
                         use_chunked=use_chunked)
    assert _close(got, ref)


def test_block_prefill_then_decode_match_reference(block):
    """A chunked prefill of 64 tokens from an empty state, then 4 decode
    steps: outputs and the f32 state (S, tm_prev, cm_prev) against the
    reference's."""
    cfg, params, tp, x = block
    jp = jax.tree.map(jnp.asarray, params)
    jcache = jrw.rwkv_cache_decl(cfg, 2)
    tcache = trw.rwkv_cache_decl(cfg, 2)
    ref, jcache = jrw.rwkv_block(jp, jnp.asarray(x[:, :64]), jcache, cfg=cfg,
                                 use_chunked=True)
    got = trw.rwkv_block(tp, torch.tensor(x[:, :64]), tcache, cfg=cfg,
                         use_chunked=True)
    assert _close(got, ref)
    for t in range(4):
        xt = np.roll(x, t, axis=1)[:, :1]
        ref, jcache = jrw.rwkv_block(jp, jnp.asarray(xt), jcache, cfg=cfg)
        got = trw.rwkv_block(tp, torch.tensor(xt), tcache, cfg=cfg)
        assert _close(got, ref), t
    for k in ("S", "tm_prev", "cm_prev"):
        assert tcache[k].dtype == torch.float32
        assert _close(tcache[k], jcache[k]), k


def test_block_takes_the_local_recurrence_for_plain_tensors(block):
    """Plain tensors run the local recurrence whatever ``dist`` says; the
    sharded block (DTensors on a mesh) is held against the reference in
    ``tests/test_torch_distributed.py``."""
    cfg, _, tp, x = block
    want = trw.rwkv_block(tp, torch.tensor(x[:, :2]), None, cfg=cfg)
    got = trw.rwkv_block(tp, torch.tensor(x[:, :2]), None, cfg=cfg,
                         dist=object())
    assert torch.equal(got, want)


def test_block_routes_like_the_reference(monkeypatch):
    """``rwkv_chunked`` takes ``wkv_chunked`` for prefill and training when
    T % 64 == 0, ``wkv_scan`` otherwise and always in decode
    (``repro.models.transformer.apply_block``)."""
    _, _, tm = _pair(ARCH)
    cfg = dataclasses.replace(tm.cfg, rwkv_chunked=True)
    tm.cfg = cfg
    seen = []
    for name in ("wkv_scan", "wkv_chunked"):
        fn = getattr(trw, name)
        monkeypatch.setattr(trw, name, lambda *a, _n=name, _f=fn, **k: (
            seen.append((_n, a[0].shape[1])), _f(*a, **k))[1])
    n = cfg.n_layers
    with torch.inference_mode():
        for T in (64, 65):
            seen.clear()
            lg, cache = tm.prefill({"tokens": torch.zeros((1, T), dtype=torch.long)},
                                   tm.init_cache(1, 80, dtype=torch.float32))
            want = "wkv_chunked" if T % 64 == 0 else "wkv_scan"
            assert seen == [(want, T)] * n
        seen.clear()
        tm.decode_step(cache, lg.argmax(-1)[:, None])
        assert seen == [("wkv_scan", 1)] * n
    seen.clear()
    tm.loss({"tokens": np.zeros((1, 65), np.int32)})
    assert seen == [("wkv_chunked", 64)] * n


def test_load_jax_params_carries_the_nested_leaves():
    _, params, tm = _pair(ARCH)
    got = dict(tm.named_parameters())
    src = jax_leaves(params)
    assert set(got) == set(src)
    assert {"segments.0.b0.1.tm.wr", "segments.0.b0.0.tm.ln_x.bias",
            "segments.0.b0.1.tm.A_w", "segments.0.b0.0.cm.wk",
            "segments.0.b0.1.ln2.scale", "final_norm.bias"} <= set(got)
    assert all(np.array_equal(got[n].numpy(), a) for n, a in src.items())
    back = stack_leaves(got)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat_a, flat_b))


# ---------------------------------------------------------------------------
# rwkv6-7b at its smoke size
# ---------------------------------------------------------------------------


def test_smoke_prefill_and_decode_match_jax():
    check_prefill_and_decode(ARCH)


def test_smoke_chunked_prefill_and_decode_match_jax():
    """``rwkv_chunked`` with a prompt of 64: the chunked WKV in prefill."""
    check_prefill_and_decode(ARCH, P_=64, rwkv_chunked=True)


def test_smoke_decode_matches_full_forward():
    check_decode_matches_full_forward(ARCH)


def test_smoke_generate_matches_jax_engine():
    check_generate(ARCH)


def test_smoke_loss_matches_reference():
    check_loss(ARCH)


def test_smoke_every_gradient_matches_reference():
    check_gradients(ARCH)


def test_states_are_f32_and_set_no_capacity():
    _, _, tm = _pair(ARCH)
    cfg = tm.cfg
    cache = tm.init_cache(2, 4, dtype=torch.bfloat16)
    c = cache["segments"][0]["b0"]
    assert {k: tuple(v.shape) for k, v in c.items()} == {
        "S": (2, 2, cfg.n_heads, cfg.head_dim, cfg.head_dim),
        "tm_prev": (2, 2, cfg.d_model), "cm_prev": (2, 2, cfg.d_model)}
    assert all(v.dtype == torch.float32 for v in c.values())
    assert ttf.cache_capacity(cfg, cache) is None


def test_full_config_param_count():
    from repro.models import zoo as jzoo
    from repro_torch.models.base import param_count
    assert param_count(ttf.model_decl(tconfigs.get(ARCH))) == \
        jzoo.build(jconfigs.get(ARCH)).n_params == 7_576_760_320
