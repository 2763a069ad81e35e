"""Multi-head Latent Attention (``models/mla.py``) and minicpm3-4b on the
CPU, held against the JAX package's ``repro.models.mla`` and its smoke
config.

The prefill runs the flash-attention wrapper (its plain version on the CPU)
at the qk head dim with V zero-padded up to it; decode runs the absorbed
form over the compressed cache. Inputs come from a numpy seed; parameters
are the JAX package's, carried across with ``load_jax_params``; everything
is f32.

Tolerances: the module's outputs within 2e-5 of their scale plus 1e-6
(f32, sums in another order); the model's logits and caches as in
``tests/test_torch_families.py`` (1e-4 of their scale plus 1e-5); the loss
within 1e-5 and every gradient within 5e-5 or twice what one ulp of the
reference's parameters does to it (``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import layers as jl
from repro.models import mla as jmla
from repro.models.base import init_tree as jax_init_tree
import repro_torch.configs as tconfigs
from repro_torch.models import layers as tl
from repro_torch.models import mla as tmla
from repro_torch.models.convert import jax_leaves, load_jax_params, stack_leaves
from test_torch_families import (_err, _pair, check_decode_matches_full_forward,
                                 check_generate, check_gradients, check_loss,
                                 check_prefill_and_decode)

ARCH = "minicpm3_4b"


def _close(got, ref) -> bool:
    ref = np.asarray(ref, np.float64)
    return _err(got, ref) <= 2e-5 * float(np.abs(ref).max()) + 1e-6


@pytest.fixture(scope="module")
def layer():
    """The smoke config at f32, one MLA layer's parameters (the JAX
    package's init) for both packages, and inputs x [2, 10, d]."""
    cfg = jconfigs.get_smoke(ARCH).scaled(compute_dtype="float32")
    params = jax.tree.map(np.asarray, jax_init_tree(
        jmla.mla_decl(cfg), jax.random.PRNGKey(3)))
    rng = np.random.default_rng(0)
    # nonzero norm scales, so a wrong slice shows
    for k in ("q_norm", "kv_norm"):
        params[k]["scale"] = rng.uniform(0.5, 1.5, params[k]["scale"].shape
                                         ).astype(np.float32)
    x = rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32)
    tp = jax.tree.map(torch.tensor, params)
    return cfg, params, tp, x


def test_rope_on_a_single_head_view():
    """MLA rotates its shared key as a one-head view [B, T, 1, dr]."""
    rng = np.random.default_rng(1)
    k = rng.normal(size=(2, 7, 1, 8)).astype(np.float32)
    pos = np.arange(3, 10)
    ref = jl.rope(jnp.asarray(k), jnp.asarray(pos, jnp.int32), 10000.0)
    got = tl.rope(torch.tensor(k), torch.tensor(pos), 10000.0)
    assert _err(got, ref) < 2e-6


@pytest.mark.parametrize("with_cache", [False, True])
def test_prefill_matches_reference(layer, with_cache):
    """The prefill (train) form: the flash wrapper's plain version at the
    qk dim with V padded, against the reference's plain attention; the
    cache filled from position 0 and zero past the prompt."""
    cfg, params, tp, x = layer
    T, S = x.shape[1], 16
    pos = np.arange(T)
    jcache = tcache = None
    if with_cache:
        jcache = jmla.mla_cache_decl(cfg, 2, S, jnp.float32)
        tcache = tmla.mla_cache_decl(cfg, 2, S, torch.float32)
    ref, jnew = jmla.mla_attention(jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(x), jnp.asarray(pos), cfg,
                                   cache=jcache)
    got = tmla.mla_attention(tp, torch.tensor(x), torch.tensor(pos), cfg,
                             cache=tcache)
    assert got.shape == ref.shape and _close(got, ref)
    if with_cache:
        for n in ("ckv", "kr"):
            assert _close(tcache[n], jnew[n])
            assert not tcache[n][:, T:].any()


def test_padded_prefill_equals_plain_attention(layer, monkeypatch):
    """V padded to the qk dim and the padded outputs dropped is exact: the
    same layer with a plain attention at V's own dim in place of the flash
    wrapper agrees to f32 rounding."""
    cfg, _, tp, x = layer
    T = x.shape[1]
    pos = torch.arange(T)
    got = tmla.mla_attention(tp, torch.tensor(x), pos, cfg)
    m = cfg.mla
    seen = []

    def plain(q, k, v, causal, window=0):
        """Causal softmax attention with V at its own dim."""
        seen.append(v.shape[-1])
        dv = m.v_head_dim
        assert causal and not v[..., dv:].any()
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
        scores = scores.masked_fill(pos[None, :] > pos[:, None], -torch.inf)
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1),
                           v[..., :dv])
        return torch.nn.functional.pad(out, (0, v.shape[-1] - dv))

    monkeypatch.setattr(tmla, "attention", plain)
    want = tmla.mla_attention(tp, torch.tensor(x), pos, cfg)
    assert seen == [m.qk_nope_head_dim + m.qk_rope_head_dim]
    assert _close(got, want)


def test_absorbed_decode_matches_reference(layer):
    """Prefill of 6 tokens, then 4 absorbed decode steps over the
    compressed cache: outputs and the cache against the reference's."""
    cfg, params, tp, x = layer
    S, P_ = 16, 6
    jp = jax.tree.map(jnp.asarray, params)
    jcache = jmla.mla_cache_decl(cfg, 2, S, jnp.float32)
    tcache = tmla.mla_cache_decl(cfg, 2, S, torch.float32)
    _, jcache = jmla.mla_attention(jp, jnp.asarray(x[:, :P_]),
                                   jnp.arange(P_), cfg, cache=jcache)
    tmla.mla_attention(tp, torch.tensor(x[:, :P_]), torch.arange(P_), cfg,
                       cache=tcache)
    for t in range(P_, P_ + 4):
        ref, jcache = jmla.mla_attention(
            jp, jnp.asarray(x[:, t:t + 1]), jnp.asarray([t]), cfg,
            cache=jcache, cache_pos=jnp.asarray(t))
        got = tmla.mla_attention(tp, torch.tensor(x[:, t:t + 1]),
                                 torch.tensor([t]), cfg, cache=tcache,
                                 cache_pos=torch.tensor(t))
        assert _close(got, ref), t
    for n in ("ckv", "kr"):
        assert _close(tcache[n], jcache[n])


def test_absorbed_decode_equals_expanded_attention(layer):
    """The port's own identity: decoding token t over the cache equals row
    t of the expanded (prefill) form over tokens 0..t."""
    cfg, _, tp, x = layer
    T = x.shape[1]
    full = tmla.mla_attention(tp, torch.tensor(x), torch.arange(T), cfg)
    cache = tmla.mla_cache_decl(cfg, 2, T, torch.float32)
    tmla.mla_attention(tp, torch.tensor(x[:, :T - 1]), torch.arange(T - 1),
                       cfg, cache=cache)
    last = tmla.mla_attention(tp, torch.tensor(x[:, T - 1:]),
                              torch.tensor([T - 1]), cfg, cache=cache,
                              cache_pos=torch.tensor(T - 1))
    assert _close(last[:, 0], full[:, -1].numpy())


def test_gradients_match_reference(layer):
    """Gradients of the prefill form through the flash wrapper's autograd
    Function (plain backward on the CPU), the padding included, against
    ``jax.grad`` of the reference."""
    cfg, params, _, x = layer
    pos = np.arange(x.shape[1])
    w = np.random.default_rng(2).normal(size=(2, x.shape[1], cfg.d_model)
                                        ).astype(np.float32)

    def jloss(p, xx):
        out, _ = jmla.mla_attention(p, xx, jnp.asarray(pos), cfg)
        return jnp.sum(out * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), params)
    tx = torch.tensor(x, requires_grad=True)
    loss = (tmla.mla_attention(tp, tx, torch.tensor(pos), cfg)
            * torch.tensor(w)).sum()
    loss.backward()
    assert _close(tx.grad, jgx)
    for name, g in jax_leaves(jax.tree.map(np.asarray, jg)).items():
        t = tp
        for key in name.split("."):
            t = t[key]
        assert _close(t.grad, g), name


def test_load_jax_params_carries_the_mla_leaves():
    jm, params, tm = _pair(ARCH)
    got = dict(tm.named_parameters())
    src = jax_leaves(params)
    assert set(got) == set(src)
    assert {"segments.0.b0.1.attn.wq_a", "segments.0.b0.0.attn.q_norm.scale",
            "segments.0.b0.1.attn.wkv_b", "segments.0.b0.0.attn.kv_norm.scale",
            "segments.0.b0.0.attn.wo"} <= set(got)
    assert all(np.array_equal(got[n].numpy(), a) for n, a in src.items())
    back = stack_leaves(got)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat_a, flat_b))


# ---------------------------------------------------------------------------
# minicpm3-4b at its smoke size
# ---------------------------------------------------------------------------


def test_smoke_prefill_and_decode_match_jax():
    check_prefill_and_decode(ARCH)


def test_smoke_decode_matches_full_forward():
    check_decode_matches_full_forward(ARCH)


def test_smoke_generate_matches_jax_engine():
    check_generate(ARCH)


def test_smoke_loss_matches_reference():
    check_loss(ARCH)


def test_smoke_every_gradient_matches_reference():
    check_gradients(ARCH)


def test_cache_capacity_counts_the_mla_slots():
    """The compressed cache is [layers, B, S, r] and [layers, B, S, dr];
    it sets the capacity, so a prompt past it raises."""
    _, _, tm = _pair(ARCH)
    cfg = tm.cfg
    cache = tm.init_cache(2, 12, dtype=torch.float32)
    c = cache["segments"][0]["b0"]
    assert tuple(c["ckv"].shape) == (2, 2, 12, cfg.mla.kv_lora_rank)
    assert tuple(c["kr"].shape) == (2, 2, 12, cfg.mla.qk_rope_head_dim)
    with torch.inference_mode(), pytest.raises(ValueError, match="exceeds"):
        tm.prefill({"tokens": torch.zeros((2, 13), dtype=torch.long)}, cache)


def test_full_config_param_count():
    from repro.models import zoo as jzoo
    from repro_torch.models import transformer as ttf
    from repro_torch.models.base import param_count
    assert param_count(ttf.model_decl(tconfigs.get(ARCH))) == \
        jzoo.build(jconfigs.get(ARCH)).n_params == 4_261_902_848
