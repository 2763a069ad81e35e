"""The RG-LRU block (``models/rglru.py``) and recurrentgemma-9b on the CPU,
held against the JAX package's ``repro.models.rglru`` and its smoke config.

The recurrence over a sequence is the reference's ``associative_scan`` with
the same combine, run as a log-step (Hillis-Steele) scan: its sums are
ordered differently from XLA's. Inputs come from a numpy seed; parameters
are the JAX package's, carried across with ``load_jax_params``; everything
is f32.

Tolerances: the causal conv exactly up to f32 rounding (1e-6 of its
scale); the scan and the block within 1e-5 of their scale plus 1e-6 (f32
products of up to ``log2 T`` factors in another order); the model's
logits and caches as in ``tests/test_torch_families.py``; the loss within
1e-5 and every gradient within 5e-5 or twice what one ulp of the
reference's parameters does to it (``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import rglru as jrg
from repro.models.base import init_tree as jax_init_tree
import repro_torch.configs as tconfigs
from repro_torch.models import rglru as trg
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import jax_leaves, stack_leaves
from test_torch_families import (_decode_against_full, _err, _pair,
                                 check_decode_matches_full_forward,
                                 check_generate, check_gradients, check_loss,
                                 check_prefill_and_decode)

ARCH = "recurrentgemma_9b"


def _close(got, ref, rel=1e-5) -> bool:
    ref = np.asarray(ref, np.float64)
    return _err(got, ref) <= rel * float(np.abs(ref).max()) + 1e-6


@pytest.fixture(scope="module")
def block():
    """The smoke config at f32, one RG-LRU block's parameters (the JAX
    package's init, with random biases and retention logits so that every
    gate is exercised) for both packages, and inputs x [2, 33, d]."""
    cfg = jconfigs.get_smoke(ARCH).scaled(compute_dtype="float32")
    params = jax.tree.map(np.asarray, jax_init_tree(
        jrg.rglru_decl(cfg), jax.random.PRNGKey(4)))
    rng = np.random.default_rng(0)
    for k in ("conv_b", "ba", "bx", "lam"):
        params[k] = rng.normal(size=params[k].shape).astype(np.float32)
    x = rng.normal(size=(2, 33, cfg.d_model)).astype(np.float32)
    return cfg, params, jax.tree.map(torch.tensor, params), x


def _state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    lru = cfg.lru_width or cfg.d_model
    return {"h": rng.normal(size=(B, lru)).astype(np.float32),
            "conv": rng.normal(size=(B, cfg.conv_width - 1, lru)
                               ).astype(np.float32)}


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(block, with_state):
    cfg, params, tp, x = block
    lru = cfg.lru_width
    xs = np.random.default_rng(5).normal(size=(2, 9, lru)).astype(np.float32)
    state = _state(cfg, 2, 6)["conv"] if with_state else None
    ref, ref_state = jrg._causal_conv(
        jnp.asarray(xs), jnp.asarray(params["conv_w"]),
        jnp.asarray(params["conv_b"]),
        None if state is None else jnp.asarray(state))
    got, got_state = trg._causal_conv(
        torch.tensor(xs), tp["conv_w"], tp["conv_b"],
        None if state is None else torch.tensor(state))
    assert _close(got, ref, 1e-6) and _close(got_state, ref_state, 0)


@pytest.mark.parametrize("T", [1, 2, 7, 64, 100])
def test_linear_scan_matches_associative_scan(T):
    """The log-step scan against ``jax.lax.associative_scan`` with the
    reference's combine, T from one step to past a power of two."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0.2, 1.0, (2, T, 8)).astype(np.float32)
    b = rng.normal(size=(2, T, 8)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c1[1] * c2[0] + c2[1]

    ra, rb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ga, gb = trg.linear_scan(torch.tensor(a), torch.tensor(b))
    assert _close(ga, ra) and _close(gb, rb)
    h, want = np.zeros((2, 8), np.float32), []
    for t in range(T):                      # the recurrence step by step
        h = a[:, t] * h + b[:, t]
        want.append(h)
    assert _close(gb, np.stack(want, 1))


def test_train_form_matches_reference(block):
    cfg, params, tp, x = block
    ref, _ = jrg.rglru_block(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(x), None, cfg=cfg)
    got = trg.rglru_block(tp, torch.tensor(x), None, cfg=cfg)
    assert _close(got, ref)


def test_prefill_with_initial_state_then_decode_match_reference(block):
    """A prefill folding in a nonzero initial state, then 5 decode steps:
    outputs and the f32 state (h, conv) against the reference's."""
    cfg, params, tp, x = block
    jp = jax.tree.map(jnp.asarray, params)
    st = _state(cfg, 2, 7)
    jcache = jax.tree.map(jnp.asarray, st)
    tcache = {k: torch.tensor(v) for k, v in st.items()}
    P_ = 20
    ref, jcache = jrg.rglru_block(jp, jnp.asarray(x[:, :P_]), jcache, cfg=cfg)
    got = trg.rglru_block(tp, torch.tensor(x[:, :P_]), tcache, cfg=cfg)
    assert _close(got, ref)
    for t in range(P_, P_ + 5):
        ref, jcache = jrg.rglru_block(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                                      cfg=cfg)
        got = trg.rglru_block(tp, torch.tensor(x[:, t:t + 1]), tcache,
                              cfg=cfg)
        assert _close(got, ref), t
    for k in ("h", "conv"):
        assert tcache[k].dtype == torch.float32
        assert _close(tcache[k], jcache[k]), k


def test_decode_steps_equal_the_sequence_form(block):
    """The port's own identity: T decode steps from an empty state equal
    the sequence form over the same T tokens."""
    cfg, _, tp, x = block
    full = trg.rglru_block(tp, torch.tensor(x[:, :12]), None, cfg=cfg)
    cache = trg.rglru_cache_decl(cfg, 2)
    steps = [trg.rglru_block(tp, torch.tensor(x[:, t:t + 1]), cache, cfg=cfg)
             for t in range(12)]
    assert _close(torch.cat(steps, 1), full.numpy())


def test_load_jax_params_carries_the_rec_leaves():
    _, params, tm = _pair(ARCH)
    got = dict(tm.named_parameters())
    src = jax_leaves(params)
    assert set(got) == set(src)
    assert {"segments.0.b0.0.rec.wa", "segments.0.b1.0.rec.conv_w",
            "segments.0.b2.0.attn.wq", "segments.1.b0.0.rec.lam"} <= set(got)
    assert all(np.array_equal(got[n].numpy(), a) for n, a in src.items())
    back = stack_leaves(got)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat_a, flat_b))


# ---------------------------------------------------------------------------
# recurrentgemma-9b at its smoke size (window 8)
# ---------------------------------------------------------------------------


def test_smoke_prefill_and_decode_match_jax():
    """The prompt (12) is past the window (8): the local block's cache
    rolls; the recurrent states are f32."""
    check_prefill_and_decode(ARCH)


def test_smoke_decode_matches_full_forward():
    check_decode_matches_full_forward(ARCH)


def test_smoke_long_decode_past_window():
    """Mirror of tests/test_serving_caches.py's: 3x past a window of 6."""
    _decode_against_full(ARCH, dict(window=6), B=1, P_=4, total=22,
                         extra=17, tol=lambda s: 2e-3 * s + 1e-4)


def test_smoke_generate_matches_jax_engine():
    check_generate(ARCH)


def test_smoke_loss_matches_reference():
    check_loss(ARCH)


def test_smoke_every_gradient_matches_reference():
    check_gradients(ARCH)


def test_caches_and_capacity():
    """The local block's cache rolls over min(window, seq_len) slots; the
    RG-LRU states are f32 whatever the cache dtype; nothing sets a
    capacity, so decode runs past seq_len."""
    _, _, tm = _pair(ARCH)
    cfg = tm.cfg
    cache = tm.init_cache(1, 6, dtype=torch.bfloat16)
    seg0 = cache["segments"][0]
    assert tuple(seg0["b0"]["h"].shape) == (1, 1, cfg.lru_width)
    assert tuple(seg0["b1"]["conv"].shape) == (1, 1, cfg.conv_width - 1,
                                               cfg.lru_width)
    assert seg0["b0"]["h"].dtype == torch.float32
    assert seg0["b2"]["k"].dtype == torch.bfloat16
    assert seg0["b2"]["k"].shape[2] == min(cfg.window, 6)
    assert ttf.cache_capacity(cfg, cache) is None
    tok = torch.zeros((1, 9), dtype=torch.long)
    cache = tm.init_cache(1, 6, dtype=torch.float32)
    with torch.inference_mode():
        lg, cache = tm.prefill({"tokens": tok}, cache)
        for _ in range(4):
            lg, cache = tm.decode_step(cache, lg.argmax(-1)[:, None])
    assert cache["pos"] == 13 and bool(torch.isfinite(lg).all())


def test_full_config_param_count():
    from repro.models import zoo as jzoo
    from repro_torch.models.base import param_count
    assert param_count(ttf.model_decl(tconfigs.get(ARCH))) == \
        jzoo.build(jconfigs.get(ARCH)).n_params == 8_578_519_040
