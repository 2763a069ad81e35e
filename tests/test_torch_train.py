"""The port's training path on the CPU, held against the JAX package: the
loss and every gradient, the flash-attention Function's backward and its
routing, the schedule and AdamW, a 5-step trajectory, microbatching,
rematerialisation, gradient compression, and the mirrors of the
reference's system tests (train, delete, train; the launcher).

The smoke llama3.2-1b at f32, parameters initialised by the JAX package and
carried across with ``load_jax_params``, batches from a numpy seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import layers as jl
from repro.models import zoo as jzoo
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import adamw_init as jadamw_init
from repro.train import make_train_step as jmake_train_step
from repro.train import optimizer as jopt
from repro.train.compression import bf16_grads as jbf16_grads
from repro.train.compression import topk_compress as jtopk_compress
from repro.train.compression import topk_init as jtopk_init
import repro_torch.configs as tconfigs
from repro_torch.kernels.flash_attention import attention, flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import transformer as ttf
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import jax_leaves, load_jax_params, stack_leaves
from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                               make_train_step)
from repro_torch.train.compression import bf16_grads, topk_compress, topk_init
from repro_torch.train.optimizer import schedule

LOSS_TOL = 1e-5        # one f32 forward, sums in another order
GRAD_TOL = 5e-5        # the reference's own (tests/test_train.py)
OPT_TOL = 1e-6         # one AdamW update from the same grads
TRAJ_TOL = 1e-4        # 5 steps: losses, and 99.9% of parameter entries
OPT_CFG = dict(lr=3e-3, warmup_steps=2, total_steps=30)
# The launcher's schedule. At OPT_CFG the smoke model's loss rises by step
# 5 and runs apart from itself: the reference against its own run from
# parameters one ulp away differs by 1.6e-3 in the loss and holds 34% of
# its entries within 1e-4, so no trajectory check can hold there.
TRAJ_CFG = dict(lr=1e-3, warmup_steps=10, total_steps=100)


def _cfgs():
    return (jconfigs.get_smoke("llama3_2_1b").scaled(compute_dtype="float32"),
            tconfigs.get_smoke("llama3.2-1b").scaled(compute_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _jax_params(seed: int = 0):
    jcfg, _ = _cfgs()
    jm = jzoo.build(jcfg)
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))


def _pair():
    """(reference model, its params as numpy, the port's model on them)."""
    jm, params = _jax_params()
    tm = tzoo.build(_cfgs()[1], device="cpu")
    load_jax_params(tm, params)
    return jm, params, tm


def _batch(vocab=256, B=4, S=32, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S + 1)).astype(np.int32)}


def _port_grads(tm, batch):
    tm.requires_grad_(True)
    loss = tm.loss(batch)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    return float(loss.detach()), {n: g.numpy() for n, g in zip(names, grads)}


def _max_err(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
               for k in a)


def _share_within(a: dict, b: dict, tol: float) -> float:
    """The share of entries of every tensor where |a - b| <= tol."""
    good = total = 0
    for k in a:
        d = np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))
        good += int((d <= tol).sum())
        total += d.size
    return good / total


def _port_params(tm) -> dict:
    return {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


def test_loss_matches_reference():
    jm, params, tm = _pair()
    batch = _batch()
    want = float(jm.loss(params, {"tokens": jnp.asarray(batch["tokens"])}))
    with torch.no_grad():
        got = float(tm.loss(batch))
    assert abs(got - want) < LOSS_TOL, (got, want)


def test_every_gradient_matches_reference():
    """Each leaf within GRAD_TOL, or within twice what rounding the
    reference's own parameters by one ulp (random signs) does to its
    gradient, where that is larger. The random-init smoke model amplifies
    rounding: at this batch one ulp of the parameters moves the
    reference's embedding gradient (max 1.5) by about 2e-4."""
    jm, params, tm = _pair()
    batch = {"tokens": jnp.asarray(_batch(seed=2)["tokens"])}
    grad = lambda p: jax_leaves(jax.tree.map(np.asarray,
                                             jax.grad(jm.loss)(p, batch)))
    want = grad(params)
    rng = np.random.default_rng(0)
    nudged = grad(jax.tree.map(lambda p: (p * (1 + rng.choice(
        [-1.0, 1.0], p.shape) * 2.0**-24)).astype(np.float32), params))
    _, got = _port_grads(tm, {"tokens": np.asarray(batch["tokens"])})
    for k in want:
        tol = max(GRAD_TOL, 2 * float(np.abs(nudged[k] - want[k]).max()))
        assert float(np.abs(got[k] - want[k]).max()) <= tol, k


def test_remat_on_matches_remat_off(monkeypatch):
    """The per-layer checkpoint changes no number: the same loss and grads
    with ``checkpoint`` replaced by a plain call (every activation kept);
    with it, each layer's attention forward runs twice (the recompute)."""
    _, _, tm = _pair()
    batch = _batch(seed=3)
    calls = []
    attn = ttf.attention
    monkeypatch.setattr(ttf, "attention",
                        lambda *a, **kw: calls.append(1) or attn(*a, **kw))
    loss_on, on = _port_grads(tm, batch)
    assert len(calls) == 2 * tm.cfg.n_layers
    monkeypatch.setattr(ttf, "checkpoint", lambda fn, *a, **kw: fn(*a))
    loss_off, off = _port_grads(tm, batch)
    assert len(calls) == 3 * tm.cfg.n_layers
    assert loss_on == loss_off
    assert _max_err(on, off) == 0.0


def test_loss_with_frames_matches_reference():
    """``Model.loss`` of an encoder-decoder, its batch carrying
    ``frames``: whisper's smoke config at f32 against the reference's
    loss within 1e-6, as tests/test_torch_encdec.py holds it."""
    jcfg = jconfigs.get_smoke("whisper_base").scaled(compute_dtype="float32")
    jm = jzoo.build(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5)))
    tm = tzoo.build(tconfigs.get_smoke("whisper_base").scaled(
        compute_dtype="float32"), device="cpu")
    load_jax_params(tm, params)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 9)).astype(np.int32),
             "frames": rng.normal(size=(2, jcfg.encoder.seq, jcfg.d_model)
                                  ).astype(np.float32)}
    want = float(jm.loss(params, jax.tree.map(jnp.asarray, batch)))
    with torch.no_grad():
        got = float(tm.loss(batch))
    assert abs(got - want) < 1e-6, (got, want)


@pytest.mark.parametrize("compute", ["bfloat16"])
def test_cast_params_once_keeps_grads_f32(compute):
    """A non-f32 compute dtype with cast_params_once: the loss runs on one
    cast of the weights, and the grads reach the f32 masters; the loss
    matches the reference's within bf16's rounding."""
    jcfg, tcfg = _cfgs()
    jcfg = jcfg.scaled(compute_dtype=compute, cast_params_once=True)
    tcfg = tcfg.scaled(compute_dtype=compute, cast_params_once=True)
    _, params = _jax_params()
    tm = tzoo.build(tcfg, device="cpu")
    load_jax_params(tm, params)
    batch = _batch(seed=4)
    want = float(jzoo.build(jcfg).loss(
        params, {"tokens": jnp.asarray(batch["tokens"])}))
    loss, grads = _port_grads(tm, batch)
    assert abs(loss - want) < 2e-2 * abs(want)
    assert all(g.dtype == np.float32 and np.isfinite(g).all()
               for g in grads.values())


# ---------------------------------------------------------------------------
# the flash-attention Function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (2, 9, 4, 1, 8),      # GQA 4:1
    (1, 12, 2, 2, 16),    # MHA
    (2, 7, 6, 2, 4),      # GQA 3:1
])
def test_attention_backward_matches_jax(B, S, H, Hkv, D):
    rng = np.random.default_rng(5)
    q, k, v, dout = (rng.normal(size=s).astype(np.float32) for s in
                     [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D),
                      (B, S, H, D)])
    pos = jnp.arange(S)

    def f(q_, k_, v_):
        out = jl.dot_attention(q_, k_, v_, pos, pos, causal=True)
        return jnp.sum(out * jnp.asarray(dout))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = attention(qt, kt, vt, causal=True)
    out.backward(torch.tensor(dout))
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < GRAD_TOL


@pytest.mark.parametrize("causal,window,kv_len", [
    (True, 0, None), (True, 3, None), (False, 0, 4), (True, 0, 5)])
def test_attention_gradcheck_f64(causal, window, kv_len):
    """Finite differences in float64 through the Function (the plain
    forward on the CPU, the plain backward)."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=torch.float64,
                            requires_grad=True)
               for s in [(1, 6, 4, 3), (1, 6, 2, 3), (1, 6, 2, 3)])
    assert torch.autograd.gradcheck(
        lambda a, b, c: attention(a, b, c, causal=causal, window=window,
                                  kv_len=kv_len), (q, k, v))


def test_attention_routes_grad_through_the_function():
    """An input that requires grad goes through the autograd Function;
    no-grad calls keep the plain path; the kernel's route refuses an input
    that requires grad and comes any other way (checked before anything
    touches CUDA); the CPU counts no launch."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.tensor(rng.normal(size=(1, 5, 2, 4)), dtype=torch.float32)
               for _ in range(3))
    before = flash_attention.launches
    assert attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_(True)
    out = attention(qg, k, v)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    with torch.no_grad():
        assert attention(qg, k, v).grad_fn is None
    with torch.inference_mode():
        assert attention(qg, k, v).grad_fn is None
    with pytest.raises(RuntimeError, match="carries no gradient"):
        flash_ops._launch(qg, k, v, causal=True, window=0, kv_len=5,
                          body="auto")
    assert flash_attention.launches == before


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_schedule_matches_reference_at_every_step():
    jcfg, tcfg = JAdamWConfig(**OPT_CFG), AdamWConfig(**OPT_CFG)
    for step in range(OPT_CFG["total_steps"] + 1):
        want = float(jopt.schedule(jcfg, jnp.asarray(step, jnp.int32)))
        got = float(schedule(tcfg, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= OPT_TOL * OPT_CFG["lr"], step


def test_adamw_update_matches_reference():
    """Two updates from the same numpy grads (the second carries m, v and
    the step); within 1e-6 on parameters, moments and stats."""
    _, params, tm = _pair()
    rng = np.random.default_rng(8)
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32) * 0.1, params) for _ in range(2)]
    cfg = dict(OPT_CFG, clip_norm=1.0)
    jstate, jparams = jadamw_init(params), params
    tstate = adamw_init(tm)
    for g in grads:
        jparams, jstate, jstats = jopt.adamw_update(g, jstate, jparams,
                                                    JAdamWConfig(**cfg))
        tg = {k: torch.tensor(x) for k, x in jax_leaves(g).items()}
        tstats = adamw_update(tg, tstate, tm, AdamWConfig(**cfg))
        for key in ("grad_norm", "lr"):
            assert abs(float(tstats[key]) - float(jstats[key])) <= \
                OPT_TOL * max(1.0, abs(float(jstats[key])))
    np_tree = lambda t: jax_leaves(jax.tree.map(np.asarray, t))
    assert _max_err(_port_params(tm), np_tree(jparams)) < OPT_TOL
    for moment in ("m", "v"):
        got = {k: x.numpy() for k, x in tstate[moment].items()}
        assert _max_err(got, np_tree(jstate[moment])) < OPT_TOL
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    assert tstate["step"].dtype == torch.int32


def test_five_step_trajectory_matches_reference():
    jm, params, tm = _pair()
    jstep = jax.jit(jmake_train_step(jm, JAdamWConfig(**TRAJ_CFG)))
    tstep = make_train_step(tm, AdamWConfig(**TRAJ_CFG), device="cpu")
    jparams, jstate = params, jadamw_init(params)
    tstate = adamw_init(tm)
    for i in range(5):
        batch = _batch(seed=10 + i)
        jparams, jstate, jm_ = jstep(jparams, jstate,
                                     {"tokens": jnp.asarray(batch["tokens"])})
        tm_ = tstep(tstate, batch)
        assert abs(float(tm_["loss"]) - float(jm_["loss"])) < TRAJ_TOL, i
    want = jax_leaves(jax.tree.map(np.asarray, jparams))
    assert _share_within(_port_params(tm), want, TRAJ_TOL) >= 0.999


def test_microbatches_match_full_batch():
    """Accumulated grads of 4 microbatches against one batch of 8 (the
    reference's check), and the step's loss against the reference's
    microbatched step."""
    jm, params, tm = _pair()
    batch = _batch(B=8, seed=20)
    seen = {}

    def capture(tag):
        def fn(grads):
            seen[tag] = {k: g.numpy().copy() for k, g in grads.items()}
            return grads
        return fn

    losses = {}
    for n in (1, 4):
        load_jax_params(tm, params)
        step = make_train_step(tm, AdamWConfig(), microbatches=n,
                               grad_transform=capture(n), device="cpu")
        losses[n] = float(step(adamw_init(tm), batch)["loss"])
    assert _max_err(seen[4], seen[1]) < GRAD_TOL
    assert abs(losses[4] - losses[1]) < 1e-4
    jstep = jmake_train_step(jm, JAdamWConfig(), microbatches=4)
    _, _, jmetrics = jstep(params, jadamw_init(params),
                           {"tokens": jnp.asarray(batch["tokens"])})
    assert abs(losses[4] - float(jmetrics["loss"])) < LOSS_TOL
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tm, AdamWConfig(), microbatches=3,
                        device="cpu")(adamw_init(tm), batch)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def test_gradient_compression_matches_reference():
    jm, params, tm = _pair()
    batch = _batch(seed=30)
    g = jax.grad(jm.loss)(params, {"tokens": jnp.asarray(batch["tokens"])})
    tg = {k: torch.tensor(x) for k, x in
          jax_leaves(jax.tree.map(np.asarray, g)).items()}
    np_tree = lambda t: jax_leaves(jax.tree.map(np.asarray, t))
    got = {k: x.numpy() for k, x in bf16_grads(tg).items()}
    assert _max_err(got, np_tree(jbf16_grads(g))) == 0.0
    jres, tres = jtopk_init(params), topk_init(tm)
    for i in range(2):        # the second step carries the residual
        jsent, jres = jtopk_compress(g, jres, fraction=0.05)
        tsent, tres = topk_compress(tg, tres, fraction=0.05)
        assert _max_err({k: x.numpy() for k, x in tsent.items()},
                        np_tree(jsent)) == 0.0
        assert _max_err({k: x.numpy() for k, x in tres.items()},
                        np_tree(jres)) == 0.0
        if i == 0:      # error feedback: sent + residual is the gradient
            for k, x in tg.items():
                assert float((tsent[k] + tres[k] - x).abs().max()) < 1e-5
                assert float((tsent[k] != 0).float().mean()) <= 0.2


def test_stack_leaves_inverts_jax_leaves():
    _, params, tm = _pair()
    back = stack_leaves(jax_leaves(params))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat_a, flat_b))
    assert stack_leaves(dict(tm.named_parameters())).keys() == params.keys()


# ---------------------------------------------------------------------------
# the reference's system tests, through the port
# ---------------------------------------------------------------------------


def test_train_from_bullion_then_delete_then_train(tmp_path):
    """Mirror of tests/test_system.py's: train on a Bullion corpus through
    the port's loader, physically delete documents with the port's
    ``delete_rows``, keep training on the same file."""
    from repro_torch.core import BullionReader, Compliance, delete_rows
    from repro_torch.data import BullionLoader, write_lm_corpus

    corpus = str(tmp_path / "c.bln")
    write_lm_corpus(corpus, n_docs=64, vocab=128, doc_len=256,
                    rows_per_group=8)
    cfg = _cfgs()[1].scaled(vocab=128)
    m = tzoo.build(cfg, device="cpu")
    opt = adamw_init(m)
    step = make_train_step(m, AdamWConfig(lr=2e-3), device="cpu")

    loader = BullionLoader(corpus, batch_size=2, seq_len=64, device="cpu")
    it = iter(loader)
    losses = []
    for _ in range(8):
        batch, _ = next(it)
        losses.append(float(step(opt, {"tokens": batch})["loss"]))
    loader.close()

    with BullionReader(corpus) as r:
        rows = r.find_rows("doc_id", np.arange(3, 8), device="cpu")
    delete_rows(corpus, rows, Compliance.LEVEL2)
    with BullionReader(corpus) as r:
        assert r.num_rows == 64
        ids = r.read_column("doc_id", device="cpu")
        assert len(ids) == 59 and not np.isin(np.arange(3, 8), ids).any()

    loader = BullionLoader(corpus, batch_size=2, seq_len=64, device="cpu")
    it = iter(loader)
    for _ in range(4):
        batch, _ = next(it)
        assert np.isfinite(float(step(opt, {"tokens": batch})["loss"]))
    loader.close()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_train_launcher_cli(tmp_path, capsys):
    """Mirror of tests/test_system.py's launcher test, with ``--device
    cpu``; then a second run resumes from the last checkpoint and takes
    the steps left, and a third has none left."""
    from repro_torch.launch.train import main
    common = ["--arch", "llama3.2-1b", "--smoke", "--batch", "2", "--seq",
              "32", "--data", str(tmp_path / "d"), "--ckpt",
              str(tmp_path / "ck"), "--ckpt-every", "6", "--log-every", "6",
              "--device", "cpu"]
    losses = main(common + ["--steps", "12"])
    assert len(losses) == 12
    assert all(np.isfinite(x) for x in losses)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["step_000000006", "step_000000012"]
    more = main(common + ["--steps", "14"])
    assert "resumed from step 12" in capsys.readouterr().out
    assert len(more) == 2 and all(np.isfinite(x) for x in more)
    assert main(common + ["--steps", "14"]) == []
