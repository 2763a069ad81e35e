"""The encoder-decoder of the port on the CPU (whisper-base's smoke config
at f32), held against the JAX package: the sinusoidal positions, the
encoder with its non-causal attention, the cross K/V, prefill, decode and
every cache tensor, the served tokens, the loss and every gradient, the
parameter count of the full config, the weight carrier and checkpoints
crossing between the packages.

Parameters are initialised by the JAX package and carried across with
``load_jax_params``; tokens and frames come from a numpy seed."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import encdec as jed
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro.models import zoo as jzoo
from repro.serve import ServeEngine as JaxServeEngine
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import adamw_init as jadamw_init
from repro.train import make_train_step as jmake_train_step
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
import repro_torch.configs as tconfigs
from repro_torch.kernels.flash_attention import attention
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import (jax_leaves, load_jax_params,
                                        reference_key, stack_leaves)
from repro_torch.serve import ServeEngine
from repro_torch.train import AdamWConfig, adamw_init, make_train_step
from repro_torch.train.checkpoint import CheckpointManager

ARCH = "whisper_base"
# Outputs and caches: tests/test_torch_families.py's bound, 1e-4 of the
# scale + 1e-5. At the random init q and k reach ~15, so an f32 softmax
# amplifies the sums' order: the port's prefill logits sit 4.7e-6 of their
# scale from the reference's and its caches 1.7e-5, where parameters one
# ulp away move the reference's own by 2.9e-6 and 4.3e-6.
REL_TOL = 1e-4
ABS_TOL = 1e-5
LOSS_TOL = 1e-6
GRAD_TOL = 5e-5         # tests/test_torch_train.py, with its ulp yardstick
STEP_TOL = 1e-4         # one AdamW step of each package from one state
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=100)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _close(got, want, rel=REL_TOL) -> bool:
    want = np.asarray(want, np.float64)
    return _err(got, want) <= rel * float(np.abs(want).max()) + ABS_TOL


def _cfgs(**kw):
    return (jconfigs.get_smoke(ARCH).scaled(compute_dtype="float32", **kw),
            tconfigs.get_smoke(ARCH).scaled(compute_dtype="float32", **kw))


@functools.lru_cache(maxsize=None)
def _jax_model():
    jm = jzoo.build(_cfgs()[0])
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _pair():
    """(reference model, its params as numpy, the port's model on them)."""
    jm, params = _jax_model()
    tm = tzoo.build(_cfgs()[1], device="cpu")
    load_jax_params(tm, params)
    return jm, params, tm


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _frames(cfg, B, seed, S=None):
    S = cfg.encoder.seq if S is None else S
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _ctx(mod, cfg, mode, T):
    if mod is jtf:
        return jtf.Ctx(cfg=cfg, mode=mode,
                       positions=jnp.arange(T, dtype=jnp.int32))
    return ttf.Ctx(cfg=cfg, mode=mode, positions=torch.arange(T))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,d", [(16, 64), (1500, 512), (7, 10)])
def test_sinusoidal_pos_matches_reference(seq, d):
    got = tl.sinusoidal_pos(seq, d)
    assert got.dtype == np.float32 and got.shape == (seq, d)
    assert np.array_equal(got, jl.sinusoidal_pos(seq, d))


def test_cross_attention_decl_matches_reference():
    got = tl.cross_attention_decl(64, 4, 16)
    want = jl.cross_attention_decl(64, 4, 16)
    assert {k: (p.shape, p.axes) for k, p in got.items()} == \
        {k: (p.shape, p.axes) for k, p in want.items()}


@pytest.mark.parametrize("S,H,Hkv", [(16, 4, 4), (37, 4, 2)])
def test_noncausal_attention_matches_dot_attention(S, H, Hkv):
    """The encoder's attention on the CPU (the kernel's plain version,
    ``attention(causal=False)``) against the reference's
    ``dot_attention(causal=False)``."""
    rng = np.random.default_rng(S)
    q = rng.normal(size=(2, S, H, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, S, Hkv, 16)).astype(np.float32)
            for _ in range(2))
    pos = jnp.arange(S, dtype=jnp.int32)
    want = jl.dot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            pos, pos, causal=False)
    got = attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                    causal=False)
    assert _close(got, want)
    causal = jl.dot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              pos, pos, causal=True)
    assert _err(got, causal) > 1e-2          # the mask is really off


# ---------------------------------------------------------------------------
# the encoder, the cross K/V, the parameters
# ---------------------------------------------------------------------------


def _encode_both(B=2, S=None):
    jm, params, tm = _pair()
    fr = _frames(tm.cfg, B, 3, S)
    jenc = jed.encode(params, jnp.asarray(fr), jm.cfg,
                      _ctx(jtf, jm.cfg, "prefill", 4))
    with torch.inference_mode():
        tenc = ted.encode(tm, torch.tensor(fr), tm.cfg,
                          _ctx(ttf, tm.cfg, "prefill", 4))
    return jm, params, tm, jenc, tenc


@pytest.mark.parametrize("S", [None, 9])
def test_encode_matches_reference(S):
    """The encoder's output for frames of the config's length (16) and of
    another (9)."""
    _, _, _, jenc, tenc = _encode_both(S=S)
    assert tuple(tenc.shape) == jenc.shape
    assert _close(tenc, jenc)


def test_encode_routes_attention_non_causal(monkeypatch):
    """Every encoder layer calls the flash-attention entry with
    causal=False, every decoder prefill layer with causal=True; nothing
    else reaches it (cross-attention is plain)."""
    _, _, tm = _pair()
    seen = []
    attn = ted.attention
    monkeypatch.setattr(ted, "attention", lambda *a, **kw: seen.append(
        (a[0].shape[1], kw["causal"])) or attn(*a, **kw))
    cfg = tm.cfg
    with torch.inference_mode():
        tm.prefill({"tokens": torch.zeros((1, 5), dtype=torch.long),
                    "frames": torch.tensor(_frames(cfg, 1, 0))},
                   tm.init_cache(1, 8, dtype=torch.float32))
    S = cfg.encoder.seq
    assert seen == [(S, False)] * cfg.encoder.n_layers + \
        [(5, True)] * cfg.n_layers


def test_cross_kv_matches_reference():
    _, params, tm, jenc, tenc = _encode_both()
    jk, jv = jed.cross_kv(params, jenc)
    with torch.inference_mode():
        tk, tv = ted.cross_kv(tm, tenc)
    for got, want in ((tk, jk), (tv, jv)):
        assert tuple(got.shape) == want.shape
        assert _close(got, want)


def test_param_count_full_config():
    """whisper-base's full config declares the reference's parameters,
    leaf for leaf (declarations only: nothing is allocated)."""
    jm = jzoo.build(jconfigs.get(ARCH))
    tdecl = ttf.model_decl(tconfigs.get(ARCH))
    from repro_torch.models.base import param_count
    assert param_count(tdecl) == jm.n_params
    assert jm.n_params > 70_000_000
    assert dataclasses.asdict(tconfigs.get(ARCH)) == \
        dataclasses.asdict(jconfigs.get(ARCH))


def test_load_jax_params_and_stack_leaves():
    """The reference's stacked ``enc_blocks``/``dec_blocks`` cross as
    per-layer parameters, and ``stack_leaves`` gives its tree back."""
    jm, params, tm = _pair()
    got = dict(tm.named_parameters())
    src = jax_leaves(params)
    assert set(got) == set(src)
    for name, arr in src.items():
        assert np.array_equal(got[name].numpy(), arr), name
    assert {"enc_blocks.1.attn.wq", "dec_blocks.0.cross_attn.wk",
            "dec_blocks.1.ln_cross.bias", "enc_norm.scale"} <= set(got)
    assert reference_key("enc_blocks.1.mlp.b_up") == \
        (["enc_blocks", "mlp", "b_up"], 1)
    back = stack_leaves(got)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat_a, flat_b))
    assert tm.n_params == jm.n_params


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_prefill_and_decode_match_jax():
    """Prefill of 6 tokens over 16 frames, 8 teacher-forced decode steps,
    and every cache tensor (self K/V, cross K/V) against the reference."""
    jm, params, tm = _pair()
    cfg = tm.cfg
    B, P_, steps, max_seq = 2, 6, 8, 20
    tok = _tokens(cfg.vocab, (B, P_ + steps), 8)
    fr = _frames(cfg, B, 4)
    jcache = jm.init_cache(B, max_seq, dtype=jnp.float32)
    tcache = tm.init_cache(B, max_seq, dtype=torch.float32)
    ref, jcache = jm.prefill(params, {"tokens": jnp.asarray(tok[:, :P_]),
                                      "frames": jnp.asarray(fr)}, jcache)
    with torch.inference_mode():
        out, tcache = tm.prefill({"tokens": torch.tensor(tok[:, :P_]).long(),
                                  "frames": torch.tensor(fr)}, tcache)
    assert _close(out, ref)
    scale = float(np.abs(np.asarray(ref)).max())
    dec = jax.jit(jm.decode_step)
    for i in range(steps):
        t = tok[:, P_ + i:P_ + i + 1]
        ref, jcache = dec(params, jcache, jnp.asarray(t))
        with torch.inference_mode():
            out, tcache = tm.decode_step(tcache, torch.tensor(t).long())
        assert _err(out, ref) <= REL_TOL * scale + ABS_TOL, i
    assert tcache["pos"] == int(jcache["pos"]) == P_ + steps
    pairs = [(tcache["self_kv"][n], jcache["self_kv"][n]) for n in "kv"] + \
        [(tcache[n], jcache[n]) for n in ("enc_k", "enc_v")]
    for got, want in pairs:
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        assert _close(got, want)


def test_prefill_takes_frames_of_another_length():
    """Frames shorter than the config's 16 give the reference's logits,
    and the cache's cross K/V take their length (the reference replaces
    them); a decode step then attends over those 9 positions."""
    jm, params, tm = _pair()
    cfg = tm.cfg
    tok = _tokens(cfg.vocab, (2, 5), 1)
    fr = _frames(cfg, 2, 2, S=9)
    ref, jcache = jm.prefill(params, {"tokens": jnp.asarray(tok),
                                      "frames": jnp.asarray(fr)},
                             jm.init_cache(2, 8, dtype=jnp.float32))
    with torch.inference_mode():
        cache = tm.init_cache(2, 8, dtype=torch.float32)
        assert cache["enc_k"].shape[2] == cfg.encoder.seq
        out, cache = tm.prefill({"tokens": torch.tensor(tok).long(),
                                 "frames": torch.tensor(fr)}, cache)
        assert cache["enc_k"].shape[2] == cache["enc_v"].shape[2] == 9
        assert _close(out, ref)
        nxt = out.argmax(-1)[:, None]
        out, cache = tm.decode_step(cache, nxt)
    ref, _ = jm.decode_step(params, jcache, jnp.asarray(nxt.numpy()))
    assert _close(out, ref)


def test_prefill_fills_the_cross_cache_in_place():
    """Frames of ``encoder.seq`` rows: the cache's own ``enc_k``/``enc_v``
    tensors take their cross K/V (no new tensors), equal to the
    reference's."""
    jm, params, tm = _pair()
    cfg = tm.cfg
    tok = _tokens(cfg.vocab, (2, 5), 3)
    fr = _frames(cfg, 2, 4)
    _, jcache = jm.prefill(params, {"tokens": jnp.asarray(tok),
                                    "frames": jnp.asarray(fr)},
                           jm.init_cache(2, 8, dtype=jnp.float32))
    with torch.inference_mode():
        cache = tm.init_cache(2, 8, dtype=torch.float32)
        before = {n: cache[n] for n in ("enc_k", "enc_v")}
        _, cache = tm.prefill({"tokens": torch.tensor(tok).long(),
                               "frames": torch.tensor(fr)}, cache)
    for n, t in before.items():
        assert cache[n] is t and t.dtype == torch.float32
        assert _close(t, jcache[n])


def test_decode_matches_full_forward():
    """The reference's invariant on the port: each decode step's logits
    equal those of a fresh prefill of the tokens so far."""
    _, _, tm = _pair()
    cfg = tm.cfg
    tok = torch.tensor(_tokens(cfg.vocab, (2, 9), 5)).long()
    fr = torch.tensor(_frames(cfg, 2, 6))
    with torch.inference_mode():
        lg, cache = tm.prefill({"tokens": tok[:, :6], "frames": fr},
                               tm.init_cache(2, 12, dtype=torch.float32))
        for i in range(6, 9):
            lg, cache = tm.decode_step(cache, tok[:, i:i + 1])
            full, _ = tm.prefill({"tokens": tok[:, :i + 1], "frames": fr},
                                 tm.init_cache(2, 12, dtype=torch.float32))
            assert _close(lg, full, rel=1e-5), i


def test_cache_capacity():
    _, _, tm = _pair()
    fr = torch.tensor(_frames(tm.cfg, 1, 0))
    tok = torch.zeros((1, 7), dtype=torch.long)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="exceeds"):
            tm.prefill({"tokens": tok, "frames": fr},
                       tm.init_cache(1, 6, dtype=torch.float32))
        _, cache = tm.prefill({"tokens": tok[:, :6], "frames": fr},
                              tm.init_cache(1, 6, dtype=torch.float32))
        with pytest.raises(ValueError, match="full"):
            tm.decode_step(cache, tok[:, :1])


def test_generate_matches_jax_engine():
    """``ServeEngine.generate(frames=)``: greedy tokens equal to the
    reference engine's."""
    jm, params, tm = _pair()
    prompts = _tokens(tm.cfg.vocab, (2, 6), 11)
    fr = _frames(tm.cfg, 2, 12)
    ref = JaxServeEngine(jm, jax.tree.map(jnp.asarray, params),
                         max_seq=20).generate(prompts, max_new_tokens=10,
                                              frames=fr)
    out = ServeEngine(tm, max_seq=20, device="cpu").generate(
        prompts, max_new_tokens=10, frames=fr)
    assert np.array_equal(out["tokens"], ref["tokens"])


def test_generate_bf16_compute_on_cpu():
    """The serving path at bf16 compute (the card's type) end to end."""
    cfg = tconfigs.get_smoke(ARCH)
    eng = ServeEngine(tzoo.build(cfg, device="cpu", dtype=torch.bfloat16),
                      max_seq=16, device="cpu")
    out = eng.generate(np.arange(12, dtype=np.int32).reshape(2, 6), 6,
                       frames=_frames(cfg, 2, 0))
    assert out["tokens"].shape == (2, 6)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab)).all()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _batch(cfg, seed, B=2, S=12):
    return {"tokens": _tokens(cfg.vocab, (B, S + 1), seed),
            "frames": _frames(cfg, B, seed + 100)}


def test_loss_matches_reference():
    jm, params, tm = _pair()
    batch = _batch(tm.cfg, 1)
    want = float(jm.loss(params, jax.tree.map(jnp.asarray, batch)))
    with torch.no_grad():
        got = float(tm.loss(batch))
    assert abs(got - want) < LOSS_TOL, (got, want)


def test_every_gradient_matches_reference():
    """``jax.value_and_grad`` of the reference's loss against the port's
    loss and ``torch.autograd.grad``, at test_torch_train.py's tolerances:
    each leaf within GRAD_TOL, or twice what one ulp of the reference's
    own parameters does to its gradient where that is larger."""
    jm, params, tm = _pair()
    batch = _batch(tm.cfg, 2)
    vg = jax.value_and_grad(jm.loss)
    jbatch = jax.tree.map(jnp.asarray, batch)
    want_loss, g = vg(params, jbatch)
    want = jax_leaves(jax.tree.map(np.asarray, g))
    rng = np.random.default_rng(0)
    _, g = vg(jax.tree.map(lambda p: (p * (1 + rng.choice(
        [-1.0, 1.0], p.shape) * 2.0**-24)).astype(np.float32), params), jbatch)
    nudged = jax_leaves(jax.tree.map(np.asarray, g))
    tm.requires_grad_(True)
    loss = tm.loss(batch)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    got = {n: x.numpy() for n, x in zip(names, grads)}
    assert abs(float(loss.detach()) - float(want_loss)) < LOSS_TOL
    assert got.keys() == want.keys()
    for k in want:
        tol = max(GRAD_TOL, 2 * _err(nudged[k], want[k]))
        assert _err(got[k], want[k]) <= tol, k
    assert float(np.abs(got["enc_blocks.0.attn.wq"]).max()) > 0


def test_train_mode_recomputes_each_layer(monkeypatch):
    """In training every encoder and decoder layer runs under a checkpoint
    (the reference's ``jax.checkpoint`` of both scan bodies); the loss and
    the gradients are the same without it."""
    _, _, tm = _pair()
    batch = _batch(tm.cfg, 3)
    calls = []
    ckpt = ted.checkpoint
    monkeypatch.setattr(ted, "checkpoint", lambda fn, *a, **kw: calls.append(
        fn.__name__) or ckpt(fn, *a, **kw))
    tm.requires_grad_(True)
    params = [p for _, p in tm.named_parameters()]
    loss_on = tm.loss(batch)
    on = torch.autograd.grad(loss_on, params)
    assert calls == ["_enc_layer"] * tm.cfg.encoder.n_layers + \
        ["_dec_layer"] * tm.cfg.n_layers
    monkeypatch.setattr(ted, "checkpoint", lambda fn, *a, **kw: fn(*a))
    loss_off = tm.loss(batch)
    off = torch.autograd.grad(loss_off, params)
    assert float(loss_on.detach()) == float(loss_off.detach())
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def _step_states(tm, opt, params, jopt):
    port = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    ref = jax_leaves(jax.tree.map(np.asarray, params))
    return port, ref


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoint_crosses_between_packages(direction, tmp_path):
    """One package takes a train step with frames and saves; the other
    restores it bit for bit; both then take one more step and agree."""
    jm, params, tm = _pair()
    jstep = jax.jit(jmake_train_step(jm, JAdamWConfig(**OPT)))
    step = make_train_step(tm, AdamWConfig(**OPT), device="cpu")
    opt = adamw_init(tm)
    jopt = jadamw_init(params)
    b0 = _batch(tm.cfg, 7)
    if direction == "reference_to_port":
        params, jopt, _ = jstep(params, jopt, jax.tree.map(jnp.asarray, b0))
        JCheckpointManager(str(tmp_path), async_save=False).save(
            1, (params, jopt))
        _, manifest = CheckpointManager(str(tmp_path)).restore(
            (tm, opt), device="cpu")
    else:
        step(opt, b0)
        CheckpointManager(str(tmp_path), async_save=False).save(1, (tm, opt))
        (params, jopt), manifest = JCheckpointManager(str(tmp_path)).restore(
            (params, jopt))
        params, jopt = (jax.tree.map(jnp.asarray, t) for t in (params, jopt))
    assert manifest["step"] == 1
    port, ref = _step_states(tm, opt, params, jopt)
    assert all(np.array_equal(port[k], ref[k]) for k in ref)
    b1 = _batch(tm.cfg, 8)
    params, jopt, jmetrics = jstep(params, jopt, jax.tree.map(jnp.asarray, b1))
    metrics = step(opt, b1)
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) < STEP_TOL
    port, ref = _step_states(tm, opt, params, jopt)
    assert all(_err(port[k], ref[k]) < STEP_TOL for k in ref)
