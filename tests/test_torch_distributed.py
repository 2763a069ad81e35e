"""The port's distributed path (``repro_torch.distributed``,
``launch/mesh.py``, the sharded model, MoE, RWKV and training step) on the
CPU, held against the JAX package.

The sharding rules and specs are compared in-process, leaf by leaf, on
stand-in meshes (objects with ``axis_names``, a ``shape`` mapping and a
``size``: all the reference's ``spec_tree`` and ``make_rules`` read), so the
production meshes need no 512 devices. The sharded runs spawn gloo ranks
once for the module (``tests/torch_dist_worker.py``): a (2, 4) ("data",
"model") mesh, and a (2, 3) one whose model axis divides no MoE chunk
count. They start from the JAX package's parameters (its checkpoint,
restored onto the mesh) and are held to the reference's **single-device**
results: its own sharded runs fail under jax 0.9, whose meshes make
Explicit axes that its embedding gather refuses.

Bounds: the reference's own tests' (``tests/test_distributed.py``): 2e-4 on
the train step's loss and every parameter, 2e-3 on the sharded MoE loss
(its aux loss is averaged over the data shards' routings); on every
leaf's gradient ``GRAD_TOL`` (5e-5, ``tests/test_torch_moe.py``), or
twice what a one-ulp nudge of the parameters moves the reference's own
gradient where that is larger (``_ref_grads``); 1e-5 on the RWKV loss,
every other family's loss, the MoE loss against the mean of the data
halves' and the MoE loss of the replicated route or an unsplit batch
(``LOSS_TOL`` of ``tests/test_torch_families.py``); 3e-5 on the sharded
flash entry's output and 5e-5 on its gradients (``tests/test_kernels.py``'s
f32 bound, ``tests/test_torch_train.py``'s ``GRAD_TOL``).
"""

import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as jconfigs
from repro.distributed import make_dist as jmake_dist
from repro.distributed import make_rules as jmake_rules
from repro.models import zoo as jzoo
from repro.models.base import spec_tree as jspec_tree
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import adamw_init as jadamw_init
from repro.train import make_train_step as jmake_train_step
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.checkpoint import _flatten as jflatten
import repro_torch.configs as tconfigs
from repro_torch.distributed import make_dist, make_rules
from repro_torch.launch import mesh as tmesh
from repro_torch.models import zoo as tzoo
from repro_torch.models.base import spec_tree
from repro_torch.models.convert import reference_key
from repro_torch.models.moe import sharded_route

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dist_worker.py")
STEP_TOL = 2e-4
MOE_TOL = 2e-3
GRAD_TOL = 5e-5
LOSS_TOL = 1e-5
ATTN_TOL = 3e-5
MOE_ARCHS = ("mixtral_8x22b", "deepseek_moe_16b")


def standin(shape: dict):
    """What the reference's mesh code reads of a ``jax.sharding.Mesh``."""
    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape),
                           size=int(np.prod(list(shape.values()))))


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x4": {"data": 2, "model": 4},
    "1x4": {"data": 1, "model": 4},
    "none": None,
}


def _mesh(name):
    return None if MESHES[name] is None else standin(MESHES[name])


def _ref_leaves(tree) -> dict:
    """A reference tree of specs or arrays by '/'-joined key path."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _port_leaves(tree, prefix=""):
    """A port declaration-shaped tree by parameter name."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _port_leaves(x, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _assert_specs_equal(port_tree, ref_tree):
    """Every port leaf (a per-layer spec) equals the reference's leaf at
    its key path, less the stacked leaf's leading 'layers' entry; every
    reference leaf is covered."""
    ref = _ref_leaves(ref_tree)
    seen = set()
    for name, spec in _port_leaves(port_tree):
        path, layer = reference_key(name)
        key = "/".join(path)
        want = tuple(ref[key])
        if layer is not None:
            assert want[0] is None, key
            want = want[1:]
        assert spec == want, (name, spec, want)
        seen.add(key)
    assert seen == set(ref)


# ---------------------------------------------------------------------------
# (a) rules and specs, in-process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_make_rules_matches_reference(mesh):
    for kw in ({}, {"fsdp": False}, {"seq_sharded": True},
               {"train_seq_sharded": True}):
        got = make_rules(_mesh(mesh), **kw)
        want = jmake_rules(_mesh(mesh), **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), kw


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_spec_tree_matches_reference(arch, mesh):
    """``spec_tree`` with the mesh's divisibility rule (GQA kv heads and
    other dims the model axis does not divide replicate)."""
    m = _mesh(mesh)
    jdecl = jzoo.build(jconfigs.get(arch)).decl
    tdecl = tzoo.build(tconfigs.get(arch), device="meta").decl
    _assert_specs_equal(spec_tree(tdecl, make_rules(m), m),
                        jspec_tree(jdecl, jmake_rules(m), m))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_param_specs_and_abstract_params_match_reference(arch, mesh):
    m = _mesh(mesh)
    jm = jzoo.build(jconfigs.get(arch), jmake_dist(m) if m else None)
    tm = tzoo.build(tconfigs.get(arch), device="meta",
                    dist=make_dist(m) if m else None)
    _assert_specs_equal(tm.param_specs(), jm.param_specs())
    ref = _ref_leaves(jm.abstract_params())
    for name, t in _port_leaves(tm.abstract_params()):
        path, layer = reference_key(name)
        want = ref["/".join(path)].shape
        assert t.device.type == "meta"
        assert tuple(t.shape) == (want[1:] if layer is not None else want)


# ---------------------------------------------------------------------------
# (f) the production meshes
# ---------------------------------------------------------------------------


def test_production_mesh_shapes(monkeypatch):
    """The port's production meshes as data equal the meshes the
    reference's ``make_production_mesh`` asks ``jax.make_mesh`` for."""
    from repro.launch import mesh as jmesh
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: standin(dict(zip(axes, shape))))
    for multi_pod in (False, True):
        want = jmesh.make_production_mesh(multi_pod=multi_pod)
        shape, axes = tmesh.PRODUCTION_MESHES[multi_pod]
        assert dict(zip(axes, shape)) == want.shape
        assert axes == want.axis_names
    assert tmesh.HBM_BW == 3.35e12 and tmesh.PEAK_FLOPS_BF16 == 989e12


def test_production_mesh_refuses_another_world(sharded):
    """Built over a world of 8, each production mesh raises, naming the
    world size it needs."""
    res = sharded["production"]
    assert "256" in res["False"] and "has 8" in res["False"]
    assert "512" in res["True"]


# ---------------------------------------------------------------------------
# (e) the MoE route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,want", [
    ({"data": 2, "model": 4}, True), ({"data": 2, "model": 3}, False),
    ({"data": 8}, False), ({"data": 1, "model": 16}, True),
    ({"data": 1, "model": 32}, False)])
def test_moe_route_rule(shape, want):
    """The sharded path where 'model' is an axis dividing the chunks (16
    for both smoke configs): the reference's condition."""
    for arch in MOE_ARCHS:
        cfg = tconfigs.get_smoke(arch)
        p = tzoo.build(cfg, device="meta").segments[-1].b0[0].moe
        assert sharded_route(p, make_dist(standin(shape))) is want
        assert sharded_route(p, None) is False


# ---------------------------------------------------------------------------
# the sharded runs
# ---------------------------------------------------------------------------


def _cfg(arch):
    cfg = jconfigs.get_smoke(arch).scaled(compute_dtype="float32")
    return cfg.scaled(capacity_factor=64.0) if cfg.n_experts else cfg


def _batch(path, cfg, shape, seed) -> str:
    """Token ids (and an encoder-decoder's frames) from the seed, saved."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int64)}
    if cfg.encoder is not None:
        batch["frames"] = rng.normal(size=(shape[0], cfg.encoder.seq,
                                           cfg.d_model)).astype(np.float32)
    np.savez(path, **batch)
    return str(path)


def _spawn(directory, world, mesh, tasks):
    directory.mkdir(parents=True, exist_ok=True)
    job = directory / "job.json"
    job.write_text(json.dumps({"world": world, "mesh": mesh,
                               "dir": str(directory), "tasks": tasks}))
    r = subprocess.run([sys.executable, WORKER, str(job)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    names = [t.get("name", t["task"]) for t in tasks]
    return {n: json.loads((directory / f"{n}.json").read_text())
            for n in names}


def _npz(directory, step):
    with np.load(os.path.join(directory, f"step_{step:09d}",
                              "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


# (H, Hkv) of the sharded attention cases on model = 4: kv heads
# replicated and read as a slice (4, 2), replicated and gathered head by
# head (12, 3: a rank's query heads 3..5 read kv heads 0, 1, 1), sharded
# alike (8, 8)
ATTENTION_CASES = ((4, 2), (12, 3), (8, 8))


def _attention_inputs(root) -> list:
    cases = []
    for H, Hkv in ATTENTION_CASES:
        rng = np.random.default_rng(H * 10 + Hkv)
        B, S, D = 4, 33, 16
        arrs = {n: rng.normal(size=s).astype(np.float32) for n, s in
                (("q", (B, S, H, D)), ("k", (B, S, Hkv, D)),
                 ("v", (B, S, Hkv, D)), ("dout", (B, S, H, D)))}
        path = root / f"attn_{H}_{Hkv}.npz"
        np.savez(path, **arrs)
        cases.append({"H": H, "Hkv": Hkv, "path": str(path)})
    return cases


LOSS_ARCHS = ("llama3_2_1b", "rwkv6_7b", "gemma3_12b", "starcoder2_15b",
              "minicpm3_4b", "recurrentgemma_9b", "chameleon_34b",
              "whisper_base") + MOE_ARCHS


# sharded serving: one smoke config of each block family, a prompt of
# SERVE_P tokens (past the smoke window of 8) and SERVE_STEPS decode steps;
# on (2, 4), (2, 3) and (1, 4) at B = 2, and on (2, 2) at B = 1, where the
# batch cannot shard and the caches' sequence is sharded over 'data' (SP)
SERVE_ARCHS = ("llama3_2_1b", "gemma3_12b", "deepseek_moe_16b",
               "minicpm3_4b", "recurrentgemma_9b", "rwkv6_7b", "whisper_base")
SERVE_P, SERVE_STEPS, SERVE_MAX_SEQ = 12, 8, 24
SERVE_MESHES = {"2x4": ([2, 4], 2), "2x3": ([2, 3], 2), "1x4": ([1, 4], 2),
                "2x2_b1": ([2, 2], 1)}


# make_dist's options for the train step: the default rules, and the
# residual stream sharded over 'model' (Megatron-style sequence parallelism)
RULES = {"default": {}, "seq_sharded": {"train_seq_sharded": True}}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The reference's parameters and batches, the gloo runs, and the
    reference's single-device results."""
    root = tmp_path_factory.mktemp("dist")
    ck, batches = {}, {}
    ref = {"grads": {}, "loss": {}, "half_loss": {}, "params": {}}
    batches3, ref3 = {}, {"grads": {}, "loss": {}}

    def load(path):
        return {k: jnp.asarray(v) for k, v in np.load(path).items()}

    serve_tok = {1: {}, 2: {}}
    for arch in LOSS_ARCHS:
        jm = jzoo.build(_cfg(arch))
        params = jm.init(jax.random.PRNGKey(0))
        if arch in SERVE_ARCHS:
            ref["params"][arch] = params
            for B in serve_tok:
                serve_tok[B][arch] = _batch(
                    root / f"serve{B}_{arch}.npz", jm.cfg, (B, SERVE_P), 3)
        ck[arch] = str(root / f"ref_{arch}")
        JCheckpointManager(ck[arch], async_save=False).save(0, params)
        shape = (4, 33) if arch == "llama3_2_1b" else (4, 17)
        batches[arch] = _batch(root / f"batch_{arch}.npz", jm.cfg, shape, 1)
        batch = load(batches[arch])
        if arch == "llama3_2_1b":
            step = jax.jit(jmake_train_step(jm, JAdamWConfig(lr=1e-3)))
            p1, _, met = step(params, jadamw_init(params), batch)
            ref["step"] = {k: float(v) for k, v in met.items()}
            ref["stepped"] = jflatten(jax.tree.map(np.asarray, p1))
            ref["grads"][arch] = _ref_grads(lambda p: jm.loss(p, batch),
                                            params)
        elif arch in MOE_ARCHS:
            ref["loss"][arch] = float(jm.loss(params, batch))
            # each data rank routes its own 2 rows: the loss is the mean of
            # the halves' (the cross-entropy's mean, the aux loss's pmean)
            halves = [{k: v[i:i + 2] for k, v in batch.items()}
                      for i in (0, 2)]
            half_loss = lambda p: sum(jm.loss(p, h) for h in halves) / 2
            ref["half_loss"][arch] = float(half_loss(params))
            ref["grads"][arch] = _ref_grads(half_loss, params)
            # 3 rows: data = 2 cannot split them
            batches3[arch] = _batch(root / f"batch3_{arch}.npz", jm.cfg,
                                    (3, 17), 2)
            b3 = load(batches3[arch])
            ref3["loss"][arch] = float(jm.loss(params, b3))
            ref3["grads"][arch] = _ref_grads(lambda p: jm.loss(p, b3),
                                             params)
        else:
            ref["loss"][arch] = float(jm.loss(params, batch))
    attn = _attention_inputs(root)
    losses = {"task": "loss_and_grads", "ckpt": ck, "batch": batches,
              "archs": [a for a in LOSS_ARCHS if a != "llama3_2_1b"],
              "grads": list(MOE_ARCHS)}
    train = {"task": "train", "arch": "llama3_2_1b", "lr": 1e-3,
             "ckpt": ck["llama3_2_1b"], "batch": batches["llama3_2_1b"]}
    llama = dict(losses, archs=["llama3_2_1b"], grads=["llama3_2_1b"])
    serve = {mesh: {"task": "serve", "name": f"serve_{mesh}", "mesh": shape,
                    "archs": list(SERVE_ARCHS), "ckpt": ck,
                    "tokens": serve_tok[B], "steps": SERVE_STEPS,
                    "max_seq": SERVE_MAX_SEQ}
             for mesh, (shape, B) in SERVE_MESHES.items()}
    out = _spawn(root / "w8", 8, [2, 4], [serve["2x4"],
        *(dict(train, name=f"train_{n}", rule_kw=kw)
          for n, kw in RULES.items()),
        *(dict(llama, name=f"llama_{n}", rule_kw=kw)
          for n, kw in RULES.items()),
        losses, dict(losses, name="moe_b3", batch=batches3,
                     archs=list(MOE_ARCHS)),
        {"task": "attention", "cases": attn}, {"task": "production"}])
    local = dict(losses, archs=list(MOE_ARCHS), grads=[])
    w6 = _spawn(root / "w6", 6, [2, 3], [local, serve["2x3"]])
    out.update(local=w6["loss_and_grads"], serve_2x3=w6["serve_2x3"])
    out.update(_spawn(root / "w4", 4, [1, 4],
                      [serve["1x4"], serve["2x2_b1"]]))
    out.update(ref=ref, ref3=ref3, attention=attn, serve_tok=serve_tok,
               dirs={"w8": root / "w8", "w6": root / "w6", "w4": root / "w4"})
    return out


def _ref_grads(loss, params):
    """``jax.grad(loss)`` by leaf, and each leaf's bound: ``GRAD_TOL``, or
    twice what rounding the parameters by one ulp (random signs) does to
    the reference's own gradient, where that is larger (the rule of
    ``tests/test_torch_train.py``: the random-init smoke models amplify
    rounding, most in the embedding's gradient)."""
    grad = lambda p: jflatten(jax.tree.map(np.asarray, jax.grad(loss)(p)))
    want = grad(params)
    rng = np.random.default_rng(0)
    nudged = grad(jax.tree.map(lambda p: (p * (1 + rng.choice(
        [-1.0, 1.0], p.shape) * 2.0**-24)).astype(np.float32), params))
    return want, {k: max(GRAD_TOL, 2 * float(np.abs(nudged[k] - want[k])
                                              .max())) for k in want}


def _assert_grads_match(directory, ref):
    """Every leaf of the gradients saved in ``directory`` against the
    reference's (``_ref_grads``), within its bound."""
    want, tol = ref
    got = _npz(directory, 0)
    assert got.keys() == want.keys()
    bad = {k: (err, tol[k]) for k in got
           if not (err := float(np.abs(got[k] - want[k]).max())) <= tol[k]}
    assert not bad, bad


@pytest.mark.parametrize("rules", list(RULES))
def test_sharded_train_step_matches_reference_single_device(sharded, rules):
    """(2, 4): one step of ``make_train_step`` on the sharded llama smoke
    model against the reference's single-device step: the loss, the global
    norm (each entry counted once) and every parameter after it. The
    config's 2 kv heads replicate over model = 4 while its 4 query heads
    shard: each rank's flash call reads its query heads' kv head. Under
    ``train_seq_sharded`` the residual stream is sharded over the sequence
    between blocks, and gathered where attention needs it whole."""
    got, ref = sharded[f"train_{rules}"], sharded["ref"]
    assert got["placed"]
    assert got["wq"] == [0, 1] and got["wk"] == [0, None]
    assert abs(got["loss"] - ref["step"]["loss"]) < STEP_TOL
    assert abs(got["grad_norm"] - ref["step"]["grad_norm"]) \
        < STEP_TOL * ref["step"]["grad_norm"]
    params = _npz(sharded["dirs"]["w8"] / f"train_{rules}", 1)
    assert params.keys() == ref["stepped"].keys()
    err = max(float(np.abs(params[k] - ref["stepped"][k]).max())
              for k in params)
    assert err < STEP_TOL, err


@pytest.mark.parametrize("rules", list(RULES))
def test_sharded_gradients_match_reference(sharded, rules):
    """(2, 4): every leaf's gradient of the sharded llama smoke loss (the
    norm weights, the embedding, the sliced GQA kv weights included)
    against ``jax.grad`` of the reference's single-device loss."""
    assert abs(sharded[f"llama_{rules}"]["llama3_2_1b"]["loss"]
               - sharded["ref"]["step"]["loss"]) < STEP_TOL
    _assert_grads_match(sharded["dirs"]["w8"] / f"grads_llama_{rules}_llama3_2_1b",
                        sharded["ref"]["grads"]["llama3_2_1b"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_moe_matches_reference_single_device(sharded, arch):
    """(2, 4), capacity factor 64 (no pair dropped): the sharded MoE path
    (each rank's chunks, psum over model) gives the reference's
    single-device loss within its bound. Each data rank routes its own
    rows, as the reference's ``shard_map`` does, so the loss is the mean of
    the reference's on each half of the batch: against that, the loss and
    every leaf's gradient (router, shared experts, chunks, the dense
    layers)."""
    got = sharded["loss_and_grads"][arch]
    assert got["sharded"] is True
    assert abs(got["loss"] - sharded["ref"]["loss"][arch]) < MOE_TOL
    assert abs(got["loss"] - sharded["ref"]["half_loss"][arch]) < LOSS_TOL
    _assert_grads_match(sharded["dirs"]["w8"] / f"grads_loss_and_grads_{arch}",
                        sharded["ref"]["grads"][arch])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_moe_on_an_unsplit_batch_matches_reference(sharded, arch):
    """(2, 4) with 3 rows, which data = 2 cannot split: every data rank
    computes the same block on the whole batch, so the sharded path sums
    its partial gradients over 'model' alone. The loss and every leaf's
    gradient (router, shared experts, chunks, the dense layers) against
    ``jax.grad``."""
    got = sharded["moe_b3"][arch]
    assert got["sharded"] is True
    assert abs(got["loss"] - sharded["ref3"]["loss"][arch]) < LOSS_TOL
    _assert_grads_match(sharded["dirs"]["w8"] / f"grads_moe_b3_{arch}",
                        sharded["ref3"]["grads"][arch])


@pytest.mark.parametrize("arch", [a for a in LOSS_ARCHS if a not in
                                  MOE_ARCHS + ("llama3_2_1b", "rwkv6_7b")])
def test_sharded_loss_matches_reference(sharded, arch):
    """(2, 4): every other family's smoke loss (windowed and global
    attention, GELU and LayerNorm, MLA, RG-LRU, qk-norm, the
    encoder-decoder) on DTensor parameters against the reference's
    single-device loss."""
    got = sharded["loss_and_grads"][arch]["loss"]
    assert abs(got - sharded["ref"]["loss"][arch]) < LOSS_TOL


@pytest.mark.parametrize("H,Hkv", ATTENTION_CASES)
def test_sharded_attention_matches_reference(sharded, H, Hkv):
    """(2, 4): the flash entry on DTensors, batch over data and query heads
    over model, each rank reading its query heads' kv heads (sliced,
    gathered head by head, or sharded alike): the output and the
    gradients of sum(out * dout) against ``dot_attention`` and
    ``jax.grad``."""
    from repro.models.layers import dot_attention
    case = next(c for c in sharded["attention"]
                if (c["H"], c["Hkv"]) == (H, Hkv))
    a = dict(np.load(case["path"]))
    got = dict(np.load(case["path"].replace(".npz", "_got.npz")))
    pos = jnp.arange(a["q"].shape[1])

    def f(q, k, v):
        out = dot_attention(q, k, v, pos, pos, causal=True)
        return jnp.sum(out * jnp.asarray(a["dout"])), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a[n]) for n in ("q", "k", "v")))
    assert float(np.abs(got["out"] - np.asarray(out)).max()) < ATTN_TOL
    for name, want in zip(("dq", "dk", "dv"), grads):
        assert float(np.abs(got[name] - np.asarray(want)).max()) < GRAD_TOL


def test_sharded_rwkv_loss_matches_reference(sharded):
    """(2, 4): the rwkv6-7b smoke loss, the WKV recurrence on each rank's
    batch rows and heads."""
    got = sharded["loss_and_grads"]["rwkv6_7b"]["loss"]
    assert abs(got - sharded["ref"]["loss"]["rwkv6_7b"]) < LOSS_TOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_local_route_on_a_non_dividing_mesh(sharded, arch):
    """(2, 3): 'model' = 3 divides no chunk count (16), so every rank
    computes the whole block on the whole batch: the reference's
    single-device loss, its aux loss included."""
    got = sharded["local"][arch]
    assert got["sharded"] is False
    assert abs(got["loss"] - sharded["ref"]["loss"][arch]) < LOSS_TOL


# ---------------------------------------------------------------------------
# sharded serving
# ---------------------------------------------------------------------------


_DECODE = {}


def _serve_reference(jm, params, batch, steps):
    """The reference's single-device prefill of the prompt in ``batch``,
    then a decode step on each column of ``steps`` [B, n]: the logits of
    each call, and the cache's leaves by key path after the last."""
    B = batch["tokens"].shape[0]
    cache = jm.init_cache(B, SERVE_MAX_SEQ, dtype=jnp.float32)
    lg, cache = jm.prefill(params, batch, cache)
    logits = [np.asarray(lg)]
    dec = _DECODE.setdefault(jm.cfg.name, jax.jit(jm.decode_step))
    for i in range(steps.shape[1]):
        lg, cache = dec(params, cache, jnp.asarray(steps[:, i:i + 1]))
        logits.append(np.asarray(lg))
    return np.stack(logits), {k: np.asarray(v)
                              for k, v in _ref_leaves(cache).items()}


def _reference_serving(sharded, arch, B, steps):
    """``_serve_reference`` on the fixture's parameters and prompts and the
    sharded engine's tokens ``steps``, and the bound of each result:
    ``_tol`` of its scale (tests/test_torch_families.py), or twice what
    rounding the parameters by one ulp (random signs) moves the
    reference's own result, where that is larger (the rule of
    ``_ref_grads``: the random init's q and k amplify the f32 softmax, and
    the shards sum in another order). Kept in the fixture's results."""
    from test_torch_families import _err, _tol
    steps = np.asarray(steps, np.int32)
    key = (arch, B, steps.tobytes())
    memo = sharded.setdefault("ref_serving", {})
    if key not in memo:
        jm = jzoo.build(_cfg(arch))
        params = sharded["ref"]["params"][arch]
        batch = {k: jnp.asarray(v) for k, v in
                 np.load(sharded["serve_tok"][B][arch]).items()}
        logits, cache = _serve_reference(jm, params, batch, steps)
        rng = np.random.default_rng(0)
        nudged = jax.tree.map(lambda p: (p * (1 + rng.choice(
            [-1.0, 1.0], p.shape) * 2.0**-24)).astype(np.float32), params)
        n_logits, n_cache = _serve_reference(jm, nudged, batch, steps)
        bound = {"logits": max(_tol(float(np.abs(logits[0]).max())),
                               2 * _err(n_logits, logits))}
        bound.update({k: max(_tol(float(np.abs(v).max())),
                             2 * _err(n_cache[k], v))
                      for k, v in cache.items()})
        memo[key] = (logits, cache, bound)
    return memo[key]


@pytest.mark.parametrize("mesh", list(SERVE_MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serving_matches_reference(sharded, arch, mesh):
    """``ServeEngine`` on the sharded model (caches DTensors placed by
    ``cache_specs``): a prefill of 12 tokens (past the smoke window of 8)
    and 8 greedy decode steps. The logits of every call against the
    reference's single-device ``prefill``/``decode_step`` fed the same
    tokens, and every cache tensor whole after the last; the position;
    the tokens equal to the unsharded engine's. Each bound
    is ``_tol`` of the result's scale, or twice the reference's own move
    under a one-ulp nudge of its parameters where larger
    (``_reference_serving``). On (2, 2) the
    batch of 1 cannot shard, so the caches' sequence is sharded over
    'data' (SP): rolling windows, MLA latents and one-position writes into
    another rank's shard included."""
    from test_torch_families import _err
    shape, B = SERVE_MESHES[mesh]
    got = sharded[f"serve_{mesh}"][arch]
    world = "w8" if mesh == "2x4" else "w6" if mesh == "2x3" else "w4"
    npz = dict(np.load(sharded["dirs"][world] / f"serve_serve_{mesh}_{arch}.npz"))
    want_logits, want_cache, bound = _reference_serving(
        sharded, arch, B, got["sharded"])
    assert _err(npz.pop("logits"), want_logits) < bound["logits"]
    assert got["pos"] == SERVE_P + SERVE_STEPS == int(want_cache["pos"])
    assert npz.keys() == want_cache.keys() - {"pos"}
    for k, want in want_cache.items():
        if k != "pos":
            assert npz[k].shape == want.shape, k
            assert _err(npz[k], want) < bound[k], k
    if mesh == "2x2_b1":
        # the batch cannot shard: the attention caches [L, B, S, Hkv, D]
        # shard their sequence over 'data' (the mesh's first dim)
        kv = [p for k, p in got["placements"].items()
              if k.split("/")[-1] in ("k", "v")]
        assert all(p[0] == 2 for p in kv), got["placements"]
    assert got["sharded"] == got["unsharded"]
