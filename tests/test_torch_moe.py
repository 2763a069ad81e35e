"""The port's MoE block (``repro_torch.models.moe``, the local path) on the
CPU, held against the JAX package's (``repro.models.moe``): the chunked
layout, routing, capacity dispatch (routes, slots and ``keep`` exactly),
the expert products over the chunk layout, and the block's output and aux
loss. The reference's ``tests/test_moe.py`` cases run on the port too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import moe as jmoe
import repro_torch.configs as tconfigs
from repro_torch.models import moe as tmoe

TOL = 1e-5      # f32, sums in another order


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _jax_params(cfg, seed=0):
    from repro.models.base import init_tree
    return jax.tree.map(np.asarray, init_tree(jmoe.moe_decl(cfg),
                                              jax.random.PRNGKey(seed)))


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


def _gap(gates: np.ndarray, k: int) -> float:
    """The smallest gap between a token's k-th and (k+1)-th gate: a tie
    there would let the two top-k routines pick different experts."""
    s = -np.sort(-gates, axis=-1)
    return float((s[:, k - 1] - s[:, k]).min()) if k < gates.shape[1] \
        else float("inf")


# ---------------------------------------------------------------------------
# the reference's tests/test_moe.py cases, on the port
# ---------------------------------------------------------------------------


def test_chunking_cases():
    assert tmoe.moe_chunking(8, 16) == (2, 16)    # Mixtral: expert-TP halves
    assert tmoe.moe_chunking(64, 16) == (1, 64)   # DeepSeek: pure EP
    assert tmoe.moe_chunking(16, 16) == (1, 16)
    assert tmoe.moe_chunking(4, 16) == (4, 16)
    for E in range(1, 70):
        assert tmoe.moe_chunking(E) == jmoe.moe_chunking(E)


def test_unchunk_roundtrip():
    rng = np.random.default_rng(0)
    E, d, ff, tp = 4, 8, 12, 4
    ff_tp = ff // tp
    dense_g = rng.normal(size=(E, d, ff)).astype(np.float32)
    chunks = np.stack([dense_g[e, :, j * ff_tp:(j + 1) * ff_tp]
                       for e in range(E) for j in range(tp)])
    got = tmoe.unchunk(torch.tensor(chunks), E, ff_axis=2)
    assert np.array_equal(got.numpy(), dense_g)
    assert np.array_equal(got.numpy(), np.asarray(
        jmoe.unchunk(jnp.asarray(chunks), E, ff_axis=2)))
    dense_d = rng.normal(size=(E, ff, d)).astype(np.float32)
    chunks_d = np.stack([dense_d[e, j * ff_tp:(j + 1) * ff_tp, :]
                         for e in range(E) for j in range(tp)])
    got = tmoe.unchunk(torch.tensor(chunks_d), E, ff_axis=1)
    assert np.array_equal(got.numpy(), dense_d)


def test_route_normalizes_topk():
    rng = np.random.default_rng(0)
    xt = torch.tensor(rng.normal(size=(32, 16)), dtype=torch.float32)
    router = torch.tensor(rng.normal(size=(16, 8)), dtype=torch.float32)
    w, idx, aux = tmoe._route(xt, router, 2)
    assert w.shape == (32, 2) and idx.shape == (32, 2)
    assert np.allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float(aux) > 0


def test_dispatch_capacity_drops():
    # all tokens to expert 0 with capacity 2: only 2 slots filled
    idx = torch.zeros((8, 1), dtype=torch.long)
    xt = torch.arange(8, dtype=torch.float32)[:, None] + 1.0
    buf, slot, keep = tmoe._dispatch(xt, idx, E=4, C=2)
    assert int(keep.sum()) == 2
    assert buf.shape == (4, 2, 1)
    assert float(buf[0].sum()) == 1.0 + 2.0  # first two tokens kept
    assert float(buf[1:].sum()) == 0.0
    assert slot.tolist() == [0, 1] + [8] * 6


def test_dispatch_no_drops_with_capacity():
    rng = np.random.default_rng(1)
    idx = torch.tensor(rng.integers(0, 4, (64, 2)))
    xt = torch.tensor(rng.normal(size=(64, 8)), dtype=torch.float32)
    buf, slot, keep = tmoe._dispatch(xt, idx, E=4, C=64)
    assert bool(keep.all())


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,d,E,k", [(32, 16, 8, 2), (96, 24, 64, 6),
                                     (40, 16, 4, 4)])
def test_route_matches_reference(T, d, E, k):
    """The same experts in the same order, the same weights and aux loss;
    the smallest k-th/(k+1)-th gate gap is reported and must not be a tie."""
    rng = np.random.default_rng(T + E)
    xt = rng.normal(size=(T, d)).astype(np.float32)
    router = (rng.normal(size=(d, E)) / np.sqrt(d)).astype(np.float32)
    jw, jidx, jaux = jmoe._route(jnp.asarray(xt), jnp.asarray(router), k)
    w, idx, aux = tmoe._route(torch.tensor(xt), torch.tensor(router), k)
    gates = np.asarray(jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(router),
                                      axis=-1))
    gap = _gap(gates, k)
    print(f"smallest gap between the k-th and (k+1)-th gate: {gap:.3e}")
    assert gap > 1e-6
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert _err(w, jw) < 1e-6
    assert abs(float(aux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("T,k,E,C", [(64, 2, 4, 64), (64, 2, 4, 20),
                                     (96, 6, 64, 3), (50, 2, 8, 1),
                                     (8, 1, 4, 2)])
def test_dispatch_matches_reference(T, k, E, C):
    """Buffer, slots and keep exactly, drops included (a pair's place in
    its expert counts over the flat [T * k] order)."""
    rng = np.random.default_rng(T * k + C)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)
    xt = rng.normal(size=(T, 8)).astype(np.float32)
    jbuf, jslot, jkeep = jmoe._dispatch(jnp.asarray(xt), jnp.asarray(idx),
                                        E, C)
    buf, slot, keep = tmoe._dispatch(torch.tensor(xt),
                                     torch.tensor(idx).long(), E, C)
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert np.array_equal(slot.numpy(), np.asarray(jslot))
    assert np.array_equal(buf.numpy(), np.asarray(jbuf))


@pytest.mark.parametrize("E,tp", [(4, 1), (4, 2), (2, 4)])
def test_experts_over_chunks_equal_dense(E, tp):
    """The products over views of the chunk layout, partials summed,
    equal the reference's dense products over ``unchunk``ed weights."""
    rng = np.random.default_rng(E * tp)
    C, d, ff = 5, 16, 24
    ff_tp = ff // tp
    p = {"wg": rng.normal(size=(E * tp, d, ff_tp)),
         "wu": rng.normal(size=(E * tp, d, ff_tp)),
         "wd": rng.normal(size=(E * tp, ff_tp, d))}
    p = {n: (w / np.sqrt(w.shape[-2])).astype(np.float32)
         for n, w in p.items()}
    buf = rng.normal(size=(E, C, d)).astype(np.float32)
    wg = jmoe.unchunk(jnp.asarray(p["wg"]), E, ff_axis=2)
    wu = jmoe.unchunk(jnp.asarray(p["wu"]), E, ff_axis=2)
    wd = jmoe.unchunk(jnp.asarray(p["wd"]), E, ff_axis=1)
    h = jnp.einsum("ecd,edf->ecf", buf, wg)
    u = jnp.einsum("ecd,edf->ecf", buf, wu)
    want = jnp.einsum("ecf,efd->ecd", jax.nn.silu(h) * u, wd)
    got = tmoe._experts(torch.tensor(buf), _torch(p), E, torch.float32)
    assert got.shape == (E, C, d)
    assert _err(got, want) < TOL * max(1.0, float(jnp.abs(want).max()))


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mixtral_8x22b"])
@pytest.mark.parametrize("capacity_factor", [1.0, 1.25, 16.0])
def test_moe_apply_matches_reference(arch, capacity_factor):
    """The block's output and aux loss at the smoke config, with drops
    (capacity 1.0 and 1.25) and without (16); the dropped pairs are the
    same ones."""
    cfg_kw = dict(capacity_factor=capacity_factor)
    jcfg = jconfigs.get_smoke(arch).scaled(**cfg_kw)
    tcfg = tconfigs.get_smoke(arch).scaled(**cfg_kw)
    params = _jax_params(jcfg)
    x = np.random.default_rng(7).normal(size=(3, 11, jcfg.d_model)).astype(
        np.float32)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, params),
                              jnp.asarray(x), jcfg)
    y, aux = tmoe.moe_apply(_torch(params), torch.tensor(x), tcfg)
    assert y.shape == x.shape
    assert _err(y, jy) < TOL * max(1.0, float(jnp.abs(jy).max()))
    assert abs(float(aux) - float(jaux)) < 1e-6
    T, k, E = 33, tcfg.top_k, tcfg.n_experts
    C = tmoe.capacity(tcfg, T)
    assert C == max(1, int(np.ceil(T * k / E * capacity_factor)))
    _, idx, _ = tmoe._route(torch.tensor(x).reshape(T, -1),
                            torch.tensor(params["router"]), k)
    _, _, keep = tmoe._dispatch(torch.tensor(x).reshape(T, -1), idx, E, C)
    _, jidx, _ = jmoe._route(jnp.asarray(x).reshape(T, -1),
                             jnp.asarray(params["router"]), k)
    _, _, jkeep = jmoe._dispatch(jnp.asarray(x).reshape(T, -1), jidx, E, C)
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    if capacity_factor == 16.0:
        assert bool(keep.all())
    elif capacity_factor == 1.0:
        assert not bool(keep.all())


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mixtral_8x22b"])
def test_moe_gradients_match_reference(arch):
    """Gradients of a scalar of the block's output plus its aux loss, with
    respect to every weight (router, expert chunks, shared experts)."""
    jcfg = jconfigs.get_smoke(arch)
    tcfg = tconfigs.get_smoke(arch)
    params = _jax_params(jcfg, seed=1)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    def f(p):
        y, aux = jmoe.moe_apply(p, jnp.asarray(x), jcfg)
        return jnp.sum(y * dy) + aux

    want = jax.grad(f)(jax.tree.map(jnp.asarray, params))
    tp = _torch(params)
    leaves = [tp["router"], tp["wg"], tp["wu"], tp["wd"]]
    if "shared" in tp:
        leaves += list(tp["shared"].values())
    for t in leaves:
        t.requires_grad_(True)
    y, aux = tmoe.moe_apply(tp, torch.tensor(x), tcfg)
    (y * torch.tensor(dy)).sum().add(aux).backward()
    for name in ("router", "wg", "wu", "wd"):
        assert _err(tp[name].grad, want[name]) < 5e-5, name
    for name, t in tp.get("shared", {}).items():
        assert _err(t.grad, want["shared"][name]) < 5e-5, name


def test_moe_block_takes_the_local_path_for_plain_tensors():
    """Plain tensors take the local path, with or without a ``dist``; the
    sharded path (DTensors on a mesh) is held against the reference in
    ``tests/test_torch_distributed.py``."""
    cfg = tconfigs.get_smoke("mixtral_8x22b")
    params = _torch(_jax_params(jconfigs.get_smoke("mixtral_8x22b")))
    x = torch.randn(1, 3, cfg.d_model, generator=torch.Generator().manual_seed(0))
    y, aux = tmoe.moe_block(params, x, cfg)
    assert y.shape == x.shape and aux.dtype == torch.float32
    y2, aux2 = tmoe.moe_block(params, x, cfg, dist=object())
    assert torch.equal(y, y2) and torch.equal(aux, aux2)


def test_moe_decl_matches_reference_layout():
    """The chunked parameter layout ([E * tp, d, ff / tp]) of both smoke
    and full configs, leaf for leaf."""
    for arch in ("deepseek_moe_16b", "mixtral_8x22b"):
        for get in ("get", "get_smoke"):
            jd = jmoe.moe_decl(getattr(jconfigs, get)(arch))
            td = tmoe.moe_decl(getattr(tconfigs, get)(arch))
            flat = lambda d: {k: (v.shape if hasattr(v, "shape") else
                                  {kk: vv.shape for kk, vv in v.items()})
                              for k, v in d.items()}
            assert flat(td) == flat(jd), (arch, get)


# ---------------------------------------------------------------------------
# the grouped (dropless) path
# ---------------------------------------------------------------------------


def _mixtral_small(capacity_factor=4.0):
    """mixtral-8x22b's block at a small size: 8 experts, top 2, no shared
    expert, two chunks an expert (tp = 2)."""
    return tconfigs.get_smoke("mixtral_8x22b").scaled(
        n_experts=8, capacity_factor=capacity_factor)


def _grouped_counts():
    from repro_torch.obs import metrics
    return (metrics.counter("bullion.moe.grouped_calls").value,
            metrics.counter("bullion.moe.grouped_pairs").value)


def _capacity_path(p, x, cfg, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(tmoe, "dropless", lambda cfg: False)
        return tmoe.moe_apply(p, x, cfg)


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("B,S", [(4, 1), (3, 40)])     # decode, prefill
def test_grouped_path_equals_capacity_path(monkeypatch, B, S, sliced):
    """At capacity factor E / k (C = T: nothing dropped) the block takes
    the grouped path, whose output and aux loss equal the capacity path's
    in f32, whole or in slices of the sorted pairs; the counters count its
    call and pairs."""
    cfg = _mixtral_small()
    assert tmoe.moe_chunking(cfg.n_experts) == (2, 16)
    assert tmoe.capacity(cfg, B * S) == B * S and tmoe.dropless(cfg)
    params = _torch(_jax_params(jconfigs.get_smoke("mixtral_8x22b").scaled(
        n_experts=8), seed=3))
    x = torch.randn(B, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(B * S))
    if sliced:      # a slice of 7 pairs: groups cross slices
        monkeypatch.setattr(tmoe, "GROUPED_SLICE_BYTES",
                            7 * params["wg"].shape[2] * 4)
    before = _grouped_counts()
    y, aux = tmoe.moe_apply(params, x, cfg)
    after = _grouped_counts()
    assert after == (before[0] + 1, before[1] + B * S * cfg.top_k)
    want, want_aux = _capacity_path(params, x, cfg, monkeypatch)
    assert _grouped_counts() == after
    assert _err(y, want) < TOL * max(1.0, float(want.abs().max()))
    assert float(aux) == float(want_aux)


def test_grouped_path_gradients_equal_capacity_path(monkeypatch):
    """The grouped path's gradients of every weight and of the input equal
    the capacity path's (training at a capacity that cannot bind)."""
    cfg = _mixtral_small()
    base = _torch(_jax_params(jconfigs.get_smoke("mixtral_8x22b").scaled(
        n_experts=8), seed=4))
    gen = torch.Generator().manual_seed(9)
    x0 = torch.randn(2, 9, cfg.d_model, generator=gen)
    dy = torch.randn(x0.shape, generator=gen)
    grads = []
    for path in ("grouped", "capacity"):
        p = {n: t.clone().requires_grad_(True) for n, t in base.items()}
        x = x0.clone().requires_grad_(True)
        y, aux = tmoe.moe_apply(p, x, cfg) if path == "grouped" else \
            _capacity_path(p, x, cfg, monkeypatch)
        (y * dy).sum().add(aux).backward()
        grads.append({n: t.grad for n, t in p.items()} | {"x": x.grad})
    for name, g in grads[0].items():
        assert _err(g, grads[1][name]) < 1e-5 * max(
            1.0, float(grads[1][name].abs().max())), name


class _Axis:
    """A model axis of m ranks, seen from rank r: what ``moe_apply`` asks of
    its mesh."""
    mesh_dim_names = ("data", "model")

    def __init__(self, r, m):
        self.r, self.m = r, m

    def get_local_rank(self, axis):
        return self.r

    def size(self, dim):
        return (1, self.m)[dim]


@pytest.mark.parametrize("m", [2, 4, 16])
def test_model_axis_keeps_capacity_path_at_e_over_k(m, monkeypatch):
    """On a model axis of m ranks a configuration that can drop no pair
    still takes the capacity path: each rank's contiguous slice of the
    chunks (whole experts, or one chunk of one at m = 16), summed over the
    ranks as ``psum`` does, gives the local grouped path's output; no
    grouped span, and the grouped counters do not move."""
    from repro_torch.obs import trace
    cfg = _mixtral_small()
    assert tmoe.dropless(cfg)
    p = _torch(_jax_params(jconfigs.get_smoke("mixtral_8x22b").scaled(
        n_experts=8), seed=5))
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator()
                    .manual_seed(m))
    want, _ = tmoe.moe_apply(p, x, cfg)
    monkeypatch.setattr(tmoe, "psum", lambda y, mesh, axes: y)
    cpr = p["wg"].shape[0] // m
    before = _grouped_counts()
    total = torch.zeros_like(x)
    with trace.collect() as tr:
        for r in range(m):
            lp = {n: p[n][r * cpr:(r + 1) * cpr] for n in ("wg", "wu", "wd")}
            lp["router"] = p["router"]
            y, _ = tmoe.moe_apply(lp, x, cfg, model_axis="model",
                                  mesh=_Axis(r, m))
            total += y
    assert len([s for s in tr.spans if s.name == "moe.experts"]) == m
    assert all("path" not in s.args for s in tr.spans)
    assert _grouped_counts() == before
    assert _err(total, want) < TOL * max(1.0, float(want.abs().max()))


def test_capacity_path_where_pairs_can_drop():
    """deepseek-moe-16b's factor of 1.25 keeps the capacity path at every
    call, a call of one token (where no pair can drop) too: no grouped
    ``moe.experts`` span, and the grouped counters do not move."""
    from repro_torch.obs import trace
    cfg = tconfigs.get_smoke("deepseek_moe_16b")
    assert cfg.capacity_factor == 1.25
    params = _torch(_jax_params(jconfigs.get_smoke("deepseek_moe_16b")))
    gen = torch.Generator().manual_seed(2)
    before = _grouped_counts()
    with trace.collect() as tr:
        for B, S in ((1, 1), (2, 1), (32, 1), (3, 11)):
            tmoe.moe_apply(params, torch.randn(B, S, cfg.d_model,
                                               generator=gen), cfg)
    assert not tmoe.dropless(cfg) and tmoe.capacity(cfg, 1) >= 1
    experts = [s for s in tr.spans if s.name == "moe.experts"]
    assert len(experts) == 4
    assert all("path" not in s.args for s in tr.spans)
    assert _grouped_counts() == before


def test_served_through_the_grouped_path_agrees_with_blocked_reference():
    """``ServeEngine``'s prefill and then decode through the grouped path,
    at a mixtral-shaped small size (GQA 4:2, 8 experts, top 2, no shared
    expert, two chunks an expert) with the benchmark's seeded weights, in
    f32: each step's logits agree with the blocked plain reference
    (``perfbench/reference/moe_lm_blocked.py``), and the served tokens are
    their argmax."""
    import json
    from pathlib import Path
    from perfbench.lib import stage_models
    from perfbench.reference.moe_lm_blocked import Reference
    from repro_torch.serve import ServeEngine
    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "perfbench/configs/mixtral-8x22b-stage.json")
                     .read_text())
    cfg.update(vocab_size=256, hidden_size=64, intermediate_size=128,
               moe_intermediate_size=32, num_hidden_layers=3,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               compute_dtype="float32", torch_dtype="float32")
    seed, B, P, n = 2**31 + 77, 3, 12, 5
    model = stage_models.build(cfg, seed, "cpu", torch.float32)
    prompts = np.random.default_rng(seed).integers(
        0, cfg["vocab_size"], (B, P)).astype(np.int32)
    before = _grouped_counts()
    tokens = ServeEngine(model, max_seq=P + n, device="cpu") \
        .generate(prompts, n)["tokens"]
    assert _grouped_counts()[0] == before[0] + 3 * (n + 1)
    with torch.inference_mode():
        cache = model.init_cache(B, P + n, dtype=torch.float32)
        logits, cache = model.prefill(
            {"tokens": torch.tensor(prompts, dtype=torch.long)}, cache)
        got = [logits]
        for i in range(n - 1):
            logits, cache = model.decode_step(
                cache, torch.tensor(tokens[:, i:i + 1], dtype=torch.long))
            got.append(logits)
    got = torch.stack(got, dim=1)                          # [B, n, V]
    seq = torch.tensor(np.concatenate([prompts, tokens[:, :-1]], axis=1),
                       dtype=torch.long)
    with torch.no_grad():
        want = Reference(cfg, seed, "cpu", torch.float32) \
            .served_logits(seq, P)
    assert got.shape == want.shape == (B, n, cfg["vocab_size"])
    assert _err(got, want) < 1e-4 * max(1.0, float(want.abs().max()))
    assert np.array_equal(got.argmax(-1).numpy(), tokens)
