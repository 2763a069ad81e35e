"""The port's checkpoints on the CPU: the reference's on-disk format (the
same npz keys, shapes and dtypes), round trip and resume equality, garbage
collection, async saves, restore checks, and checkpoints written by either
package restored by the other, each then taking one step equal to the
writer's own."""

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import zoo as jzoo
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import adamw_init as jadamw_init
from repro.train import make_train_step as jmake_train_step
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
import repro_torch.configs as tconfigs
from repro_torch.models import zoo as tzoo
from repro_torch.models.base import tree_map
from repro_torch.models.convert import jax_leaves, load_jax_params
from repro_torch.train import AdamWConfig, adamw_init, make_train_step
from repro_torch.train.checkpoint import CheckpointManager

# one step of each package from the same state: as test_torch_train.py's
# trajectory (the launcher's schedule)
STEP_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=100)


def _cfgs():
    return (jconfigs.get_smoke("llama3_2_1b").scaled(compute_dtype="float32"),
            tconfigs.get_smoke("llama3.2-1b").scaled(compute_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _reference():
    jm = jzoo.build(_cfgs()[0])
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, params, jax.jit(jmake_train_step(jm, JAdamWConfig(**OPT)))


def _port(params=None):
    tm = tzoo.build(_cfgs()[1], device="cpu", seed=1)
    if params is not None:
        load_jax_params(tm, params)
    return tm, adamw_init(tm)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (4, 33)).astype(np.int32)}


def _port_state(tm, opt) -> dict:
    """Parameters and moments by port name, and the step, as numpy."""
    out = {f"p/{n}": p.detach().numpy().copy() for n, p in tm.named_parameters()}
    for moment in ("m", "v"):
        out.update({f"{moment}/{n}": x.numpy().copy()
                    for n, x in opt[moment].items()})
    out["step"] = opt["step"].numpy().copy()
    return out


def _ref_state(params, opt) -> dict:
    host = lambda t: jax_leaves(jax.tree.map(np.asarray, t))
    out = {f"p/{n}": x for n, x in host(params).items()}
    for moment in ("m", "v"):
        out.update({f"{moment}/{n}": x for n, x in host(opt[moment]).items()})
    out["step"] = np.asarray(opt["step"])
    return out


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) and np.asarray(a[k]).dtype ==
        np.asarray(b[k]).dtype for k in a)


def _share_within(a: dict, b: dict, tol: float) -> float:
    d = [np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))
         for k in a]
    return sum(int((x <= tol).sum()) for x in d) / sum(x.size for x in d)


def _npz(directory, step):
    return np.load(os.path.join(directory, f"step_{step:09d}", "arrays.npz"))


def test_roundtrip_and_resume_equality(tmp_path):
    tm, opt = _port()
    step = make_train_step(tm, AdamWConfig(lr=1e-3), device="cpu")
    for i in range(3):
        step(opt, _batch(i))
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(3, (tm, opt), extra={"epoch": 0, "group": 1})
    tm2, opt2 = _port()
    _, manifest = mgr.restore((tm2, opt2), device="cpu")
    assert manifest["step"] == 3 and manifest["group"] == 1
    assert manifest["n_arrays"] == 3 * 11 + 1   # params, m, v; the step
    assert _equal(_port_state(tm2, opt2), _port_state(tm, opt))
    # continue both and compare exactly
    step2 = make_train_step(tm2, AdamWConfig(lr=1e-3), device="cpu")
    a, b = step(opt, _batch(9)), step2(opt2, _batch(9))
    assert float(a["loss"]) == float(b["loss"])
    assert _equal(_port_state(tm2, opt2), _port_state(tm, opt))


def test_gc_latest_and_stale_tmp(tmp_path):
    tm, _ = _port()
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    stale, fresh = tmp_path / "step_000000099.tmp", tmp_path / "step_000000098.tmp"
    stale.mkdir()
    fresh.mkdir()
    old = time.time() - 600
    os.utime(stale, (old, old))
    for s in (1, 2, 3, 4):
        mgr.save(s, {"p": tm})
    assert mgr.latest_step() == 4
    assert mgr._complete_steps() == [3, 4]
    assert not stale.exists() and fresh.exists()


def test_async_save_and_its_error(tmp_path, monkeypatch):
    tm, _ = _port()
    mgr = CheckpointManager(str(tmp_path), keep=1, async_save=True)
    mgr.save(7, {"p": tm})
    mgr.wait()
    assert mgr.latest_step() == 7

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", fail)
    mgr.save(8, {"p": tm})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() == 7


def test_save_copies_to_the_host_before_returning(tmp_path, monkeypatch):
    """The state may change right after ``save`` returns: the arrays were
    copied first, only the write runs on the thread."""
    tm, opt = _port()
    release = []
    real = np.savez

    def slow(*a, **k):
        while not release:
            time.sleep(0.01)
        return real(*a, **k)

    monkeypatch.setattr(np, "savez", slow)
    mgr = CheckpointManager(str(tmp_path), keep=1, async_save=True)
    mgr.save(1, (tm, opt))
    want = _port_state(tm, opt)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    release.append(True)
    mgr.wait()
    tm2, opt2 = _port()
    mgr.restore((tm2, opt2), device="cpu")
    assert _equal(_port_state(tm2, opt2), want)


def test_npz_keys_shapes_and_dtypes_match_reference(tmp_path):
    _, params, _ = _reference()
    JCheckpointManager(str(tmp_path / "j"), async_save=False).save(
        1, (params, jadamw_init(params)))
    tm, opt = _port()
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(1, (tm, opt))
    with _npz(tmp_path / "j", 1) as zj, _npz(tmp_path / "t", 1) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert {"0/embed", "0/segments/0/b0/attn/wq", "1/m/embed",
                "1/v/segments/0/b0/mlp/w_up", "1/step"} <= set(zt.files)
        for k in zj.files:
            assert zj[k].shape == zt[k].shape and zj[k].dtype == zt[k].dtype, k


def test_restore_checks(tmp_path):
    tm, opt = _port()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    with pytest.raises(FileNotFoundError):
        mgr.restore((tm, opt), device="cpu")
    mgr.save(1, {"p": tm})
    with pytest.raises(KeyError, match="0/embed"):
        mgr.restore((tm, opt), device="cpu")
    fresh = tzoo.build(_cfgs()[1], device="cpu", seed=2)
    narrow = tzoo.build(_cfgs()[1].scaled(d_ff=64), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"p": narrow}, device="cpu")
    # shardings (the elastic path) that plain tensors cannot meet
    unplaced = {"p": tree_map(lambda p: (None, ()), fresh.decl)}
    with pytest.raises(ValueError, match="not placed as asked"):
        mgr.restore({"p": fresh}, shardings=unplaced, device="cpu")
    mgr.restore({"p": fresh}, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(),
                                                 tm.parameters()))


def test_reference_checkpoint_restores_in_port(tmp_path):
    """The reference trains 2 steps and saves; the port restores it (equal
    to the reference's state, bit for bit), then both take one step."""
    _, params, jstep = _reference()
    jopt = jadamw_init(params)
    for i in range(2):
        params, jopt, _ = jstep(params, jopt, {"tokens": jnp.asarray(
            _batch(i)["tokens"])})
    JCheckpointManager(str(tmp_path), async_save=False).save(
        2, (params, jopt), extra={"epoch": 0, "group": 3})
    tm, opt = _port()
    _, manifest = CheckpointManager(str(tmp_path)).restore((tm, opt),
                                                           device="cpu")
    assert manifest["step"] == 2 and manifest["group"] == 3
    assert _equal(_port_state(tm, opt), _ref_state(params, jopt))
    batch = _batch(5)
    params, jopt, jm = jstep(params, jopt, {"tokens": jnp.asarray(
        batch["tokens"])})
    tmetrics = make_train_step(tm, AdamWConfig(**OPT), device="cpu")(opt, batch)
    assert abs(float(tmetrics["loss"]) - float(jm["loss"])) < STEP_TOL
    assert _share_within(_port_state(tm, opt), _ref_state(params, jopt),
                         STEP_TOL) >= 0.999


def test_port_checkpoint_restores_in_reference(tmp_path):
    """The port trains 2 steps and saves; the reference restores it (equal
    to the port's state, bit for bit), then both take one step."""
    _, params0, jstep = _reference()
    tm, opt = _port(params0)
    step = make_train_step(tm, AdamWConfig(**OPT), device="cpu")
    for i in range(2):
        step(opt, _batch(i))
    CheckpointManager(str(tmp_path), async_save=False).save(2, (tm, opt))
    template = (params0, jadamw_init(params0))
    (params, jopt), manifest = JCheckpointManager(str(tmp_path)).restore(
        template)
    assert manifest["step"] == 2
    assert _equal(_ref_state(params, jopt), _port_state(tm, opt))
    batch = _batch(5)
    params, jopt, jm = jstep(jax.tree.map(jnp.asarray, params),
                             jax.tree.map(jnp.asarray, jopt),
                             {"tokens": jnp.asarray(batch["tokens"])})
    tmetrics = step(opt, batch)
    assert abs(float(tmetrics["loss"]) - float(jm["loss"])) < STEP_TOL
    assert _share_within(_port_state(tm, opt), _ref_state(params, jopt),
                         STEP_TOL) >= 0.999
