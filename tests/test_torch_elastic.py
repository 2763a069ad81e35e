"""Elastic rescale in the port (``repro_torch.train.elastic``) on the CPU: a
checkpoint saved under one mesh restores onto another, held against the
JAX package.

A sharded llama smoke model is saved from a (2, 4) gloo group (every rank
gathers, rank 0 writes) and restored onto a fresh (1, 4) group: bit-equal
parameters with the new mesh's placements, and a finite loss after. A
checkpoint written by the reference's ``CheckpointManager`` restores
through the port's ``elastic_restore`` onto the same mesh, bit-equal, and
its loss is the reference's single-device loss within ``LOSS_TOL`` (the
families' bound, ``tests/test_torch_families.py``). ``reshard_plan`` is
the reference's dict on stand-in meshes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as jconfigs
from repro.models import zoo as jzoo
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.checkpoint import _flatten as jflatten
from repro.train.elastic import reshard_plan as jreshard_plan
import repro_torch.configs as tconfigs
from repro_torch.models import zoo as tzoo
from repro_torch.train.elastic import reshard_plan
from test_torch_distributed import MESHES, _npz, _spawn, standin

LOSS_TOL = 1e-5
ARCH = "llama3_2_1b"


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    cfg = jconfigs.get_smoke(ARCH).scaled(compute_dtype="float32")
    jm = jzoo.build(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    JCheckpointManager(str(root / "ref"), async_save=False).save(7, params)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int64)
    np.savez(root / "batch.npz", tokens=tokens)
    saved = _spawn(root / "w8", 8, [2, 4],
                   [{"task": "save", "arch": ARCH, "seed": 0}])
    out = _spawn(root / "w4", 4, [1, 4], [
        {"task": "elastic", "arch": ARCH, "seed": 3,
         "batch": str(root / "batch.npz"),
         "ckpts": {"port": str(root / "w8" / "elastic"),
                   "reference": str(root / "ref")}}])["elastic"]
    return {"saved": saved["save"], "out": out, "root": root,
            "ref_params": jflatten(jax.tree.map(np.asarray, params)),
            "ref_loss": float(jm.loss(params, {"tokens": jnp.asarray(tokens)}))}


def test_restore_onto_a_smaller_mesh(restored):
    """Saved from (2, 4), restored onto (1, 4): bit-equal, placed by the new
    mesh's specs, and the restored model trains (a finite loss)."""
    root, got = restored["root"], restored["out"]["port"]
    assert restored["saved"]["placed"]
    assert got["step"] == 5 and got["placed"]
    assert np.isfinite(got["loss"])
    saved = _npz(root / "w8" / "elastic", 5)
    back = _npz(root / "w4" / "restored_port", 0)
    assert saved.keys() == back.keys()
    for k in saved:
        assert np.array_equal(saved[k], back[k]), k


def test_reference_checkpoint_restores_through_elastic_restore(restored):
    """A checkpoint the JAX package wrote restores onto the (1, 4) mesh:
    bit-equal to the reference's parameters, and the reference's loss."""
    root, got = restored["root"], restored["out"]["reference"]
    assert got["step"] == 7 and got["placed"]
    back = _npz(root / "w4" / "restored_reference", 0)
    want = restored["ref_params"]
    assert back.keys() == want.keys()
    for k in want:
        assert np.array_equal(back[k], want[k]), k
    assert abs(got["loss"] - restored["ref_loss"]) < LOSS_TOL


PAIRS = [("2x4", "1x4"), ("16x16", "2x16x16"), ("2x16x16", "16x16"),
         ("1x4", "2x4")]


@pytest.mark.parametrize("old,new", PAIRS)
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_reshard_plan_matches_reference(arch, old, new):
    jdecl = jzoo.build(jconfigs.get(arch)).decl
    tdecl = tzoo.build(tconfigs.get(arch), device="meta").decl
    a, b = standin(MESHES[old]), standin(MESHES[new])
    assert reshard_plan(tdecl, a, b) == jreshard_plan(jdecl, a, b)


def test_reshard_plan_reports_changes():
    """Growing the model axis from 4 to 16 moves GQA kv heads and more: the
    plan is not empty, so the equality above compares entries."""
    decl = tzoo.build(tconfigs.get(ARCH), device="meta").decl
    plan = reshard_plan(decl, standin(MESHES["2x4"]),
                        standin(MESHES["16x16"]))
    assert plan["new_devices"] == 256
    assert {"param": "segments/0/b0/attn/wk",
            "old": "PartitionSpec(None, 'data', 'model', None)",
            "new": "PartitionSpec(None, 'data', None, None)"} \
        in plan["changed"]
