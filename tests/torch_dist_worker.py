"""Rank code of the port's multi-process CPU tests (gloo): one process a
rank, spawned from this script, on a ("data", "model") mesh.

    python tests/torch_dist_worker.py JOB.json

JOB: {"world": 8, "mesh": [2, 4], "dir": DIR, "tasks": [{"task": ..., ...}]}.
Each task writes its results under DIR (rank 0 alone: ``<name>.json``, the
task's "name" or else its "task", and
the port's checkpoints); the parent test holds them against the JAX
package. Every rank runs with one thread; the group meets through a file
under DIR and is destroyed at the end.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import make_dist  # noqa: E402
from repro_torch.distributed.placement import placements  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_test_mesh)
from repro_torch.models import zoo  # noqa: E402
from repro_torch.models.base import by_name, spec_tree  # noqa: E402
from repro_torch.models.moe import sharded_route  # noqa: E402
from repro_torch.train import (AdamWConfig, adamw_init,  # noqa: E402
                               make_train_step)
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.elastic import elastic_restore  # noqa: E402


def _cfg(arch: str):
    cfg = configs.get_smoke(arch).scaled(compute_dtype="float32")
    return cfg.scaled(capacity_factor=64.0) if cfg.n_experts else cfg


def _model(arch, mesh, ckpt=None, seed=0, rule_kw=None):
    """The smoke model on ``mesh`` (``make_dist``'s options ``rule_kw``),
    from the JAX package's parameters in checkpoint ``ckpt`` (restored
    onto the mesh), or from ``seed``."""
    cfg = _cfg(arch)
    rule_kw = rule_kw or {}
    m = zoo.build(cfg, device="cpu", seed=seed,
                  dist=make_dist(mesh, **rule_kw))
    if ckpt is not None:
        elastic_restore(CheckpointManager(ckpt), m, m.decl, mesh, **rule_kw)
    return m


def _placed_by_spec(m, mesh) -> bool:
    specs = spec_tree(m.decl, m.dist.rules, mesh)
    params = dict(m.named_parameters())
    return all(tuple(p.placements) == placements(by_name(specs, name), mesh)
               for name, p in params.items())


def _batch(path) -> dict:
    """A batch saved by the test: {"tokens"} (and "frames")."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def task_train(mesh, t, out):
    m = _model(t["arch"], mesh, t["ckpt"], rule_kw=t.get("rule_kw"))
    attn = m.segments[0].b0[0].attn
    # the dim each mesh axis shards, None where it replicates
    res = {"placed": _placed_by_spec(m, mesh),
           **{w: [getattr(p, "dim", None) for p in attn[w].placements]
              for w in ("wq", "wk")}}
    step = make_train_step(m, AdamWConfig(lr=t["lr"]), device="cpu")
    stats = step(adamw_init(m), _batch(t["batch"]))
    res.update({k: float(v) for k, v in stats.items()})
    CheckpointManager(os.path.join(out, _name(t)),
                      async_save=False).save(1, m)
    return res


def task_loss_and_grads(mesh, t, out):
    """Each arch's loss (and, for those in ``t["grads"]``, its gradients,
    saved as ``grads_<name>_<arch>``) on the JAX package's parameters and
    batch (``frames`` too for an encoder-decoder), under ``make_dist``'s
    options ``t["rule_kw"]``."""
    res = {}
    for arch in t["archs"]:
        m = _model(arch, mesh, t["ckpt"][arch], rule_kw=t.get("rule_kw"))
        m.requires_grad_(True)
        params = dict(m.named_parameters())
        with m.sharded_ops():
            loss = m.loss(_batch(t["batch"][arch]))
            grads = torch.autograd.grad(loss, list(params.values())) \
                if arch in t.get("grads", ()) else None
        res[arch] = {"loss": float(loss),
                     "sharded": sharded_route(
                         m.segments[-1].b0[0].moe, m.dist)
                     if m.cfg.n_experts else None}
        if grads is not None:
            CheckpointManager(os.path.join(out, f"grads_{_name(t)}_{arch}"),
                              async_save=False).save(
                0, dict(zip(params, grads)))
    return res


def task_attention(mesh, t, out):
    """``attention`` on DTensors q [B, S, H, D] (batch over data, heads over
    model) and k, v [B, S, Hkv, D] (kv heads over model where it divides
    them, else replicated), and its backward of sum(out * dout): the output
    and the gradients, whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.flash_attention import attention
    for case in t["cases"]:
        arrs = np.load(case["path"])
        kv = Shard(2) if case["Hkv"] % mesh.size(1) == 0 else Replicate()
        q, k, v = (distribute_tensor(torch.tensor(arrs[n]), mesh, plc)
                   .requires_grad_(True) for n, plc in
                   (("q", [Shard(0), Shard(2)]), ("k", [Shard(0), kv]),
                    ("v", [Shard(0), kv])))
        o = attention(q, k, v, causal=True)
        dout = distribute_tensor(torch.tensor(arrs["dout"]), mesh,
                                 o.placements)
        torch.autograd.backward(o, dout)
        got = {n: x.full_tensor().detach().numpy() for n, x in
               (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}
        if tdist.get_rank() == 0:
            np.savez(case["path"].replace(".npz", "_got.npz"), **got)
    return {}


def task_production(mesh, t, out):
    res = {}
    for multi_pod in (False, True):
        try:
            make_production_mesh(multi_pod=multi_pod)
            res[str(multi_pod)] = None
        except ValueError as e:
            res[str(multi_pod)] = str(e)
    return res


def task_save(mesh, t, out):
    m = _model(t["arch"], mesh, seed=t["seed"])
    mgr = CheckpointManager(os.path.join(out, "elastic"), async_save=True)
    mgr.save(5, m)
    mgr.wait()
    return {"placed": _placed_by_spec(m, mesh)}


def task_elastic(mesh, t, out):
    res = {}
    for name, ckpt in t["ckpts"].items():
        m = _model(t["arch"], mesh, seed=t["seed"])
        _, manifest = elastic_restore(CheckpointManager(ckpt), m, m.decl,
                                      mesh)
        whole = {k: p.full_tensor() for k, p in m.named_parameters()}
        with m.sharded_ops():
            loss = float(m.loss(_batch(t["batch"])))
        res[name] = {"step": manifest["step"], "loss": loss,
                     "placed": _placed_by_spec(m, mesh)}
        if tdist.get_rank() == 0:
            CheckpointManager(os.path.join(out, f"restored_{name}"),
                              async_save=False).save(0, whole)
    return res


def _whole(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()


def _cache_leaves(tree, prefix=""):
    """A cache's tensors by '/'-joined key path."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _cache_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _cache_leaves(x, f"{prefix}{i}/")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree


def _recorded(model) -> dict:
    """Record the logits of each ``prefill``/``decode_step`` call of
    ``model`` (whole) and the last cache it made (``rec``)."""
    rec = {"logits": []}
    prefill, decode, init = model.prefill, model.decode_step, model.init_cache

    def keep(out):
        rec["logits"].append(_whole(out[0]))
        return out

    def init_cache(*args, **kwargs):
        rec["cache"] = init(*args, **kwargs)
        return rec["cache"]

    model.prefill = lambda *a: keep(prefill(*a))
    model.decode_step = lambda *a: keep(decode(*a))
    model.init_cache = init_cache
    return rec


def task_serve(mesh, t, out):
    """Sharded serving of each arch (on the mesh ``t["mesh"]`` where given):
    the JAX package's parameters restored onto the mesh, ``ServeEngine``
    over the saved prompts (and frames), ``t["steps"]`` greedy tokens; the
    logits of its prefill and of each decode step and every cache tensor
    whole after the last (``serve_<name>_<arch>.npz``), its tokens and the
    unsharded engine's on the same parameters, and the dim each mesh axis
    shards in each cache tensor."""
    from repro_torch.serve import ServeEngine
    if "mesh" in t:
        mesh = make_test_mesh(*t["mesh"])
    res = {}
    for arch in t["archs"]:
        m = _model(arch, mesh, t["ckpt"][arch])
        batch = _batch(t["tokens"][arch])
        rec = _recorded(m)
        m0 = zoo.build(_cfg(arch), device="cpu")
        CheckpointManager(t["ckpt"][arch]).restore(m0, device="cpu")
        gen = {name: ServeEngine(model, max_seq=t["max_seq"], device="cpu")
               .generate(batch["tokens"], t["steps"],
                         frames=batch.get("frames"))["tokens"].tolist()
               for name, model in (("sharded", m), ("unsharded", m0))}
        cache = dict(rec["cache"])
        pos = int(cache.pop("pos"))     # a plain tensor beside the DTensors
        leaves = {k: _whole(v) for k, v in _cache_leaves(cache)}
        # the dim each mesh axis shards, None where it replicates
        plc = {k: [getattr(p, "dim", None) for p in v.placements]
               for k, v in _cache_leaves(cache)}
        res[arch] = {"pos": pos, "placements": plc, **gen}
        if tdist.get_rank() == 0:
            np.savez(os.path.join(out, f"serve_{_name(t)}_{arch}.npz"),
                     logits=np.stack(rec["logits"]), **leaves)
    return res


def _name(t: dict) -> str:
    return t.get("name", t["task"])


TASKS = {"train": task_train, "loss_and_grads": task_loss_and_grads,
         "attention": task_attention, "production": task_production, "save": task_save,
         "elastic": task_elastic, "serve": task_serve}


def _rank(rank: int, job: dict) -> None:
    torch.set_num_threads(1)
    out = job["dir"]
    tdist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out, 'rendezvous')}",
        rank=rank, world_size=job["world"])
    try:
        mesh = make_test_mesh(*job["mesh"])
        for t in job["tasks"]:
            res = TASKS[t["task"]](mesh, t, out)
            if rank == 0:
                with open(os.path.join(out, f"{_name(t)}.json"), "w") as f:
                    json.dump(res, f)
    finally:
        tdist.destroy_process_group()


def main(path: str) -> None:
    with open(path) as f:
        job = json.load(f)
    mp.start_processes(_rank, args=(job,), nprocs=job["world"],
                       start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1])
