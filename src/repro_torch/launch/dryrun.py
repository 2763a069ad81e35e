"""Multi-pod dry run, ported from ``repro.launch.dryrun``: run every
(architecture x input-shape) cell once on the production meshes, on fake
tensors, and record memory, cost and collective artifacts.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

The reference lowers and compiles each cell over 512 forced host devices
and reads XLA's HLO. Here one process joins a ``fake`` process group of
world 256 (16x16) or 512 (2x16x16), builds the production mesh over it,
and runs the cell's step once under ``FakeTensorMode``: parameters,
caches and activations are DTensors whose local shards are fake (shapes,
no storage), and every collective returns at once. ``hlo_cost.Counter``
counts the ops that run on one rank's local shards (the per-device
FLOPs, bytes and collective bytes) and the peak of the bytes they hold
live. ``trace_s`` is the time of that run (the reference's
``lower_s``/``compile_s``).

A fake group cannot share a process with another default group, so tests
and ``chip_smoke.py`` run this as a subprocess.

Artifacts land in artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json and
feed ``launch.report``'s roofline table.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from .. import configs
from ..models.base import mesh_axes
from ..models.config import SHAPES

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")


def cache_specs(cache, cfg, dist):
    """Shape-aware KV/state cache specs (SP when batch is unshardable): the
    cache's tree with a spec (a tuple) at each tensor and ``()`` at
    ``pos``, by the reference's rules, leaf for leaf. A leaf's rule reads
    its key and its stacked shape ([L, ...]; the k/v of attention and of
    the encoder-decoder [L, B, S, H, D])."""
    sizes = mesh_axes(dist.mesh)
    M = sizes["model"]

    def leaf_spec(key, shape):
        if key in ("enc_k", "enc_v"):
            key = key[-1]  # treat like stacked k/v
        if key == "pos":
            return ()
        batch_dim = 1 if key in ("k", "v") and len(shape) == 5 else 0
        b_ax = dist.batch_axes_for(shape[batch_dim])
        seq_ax = None
        if b_ax is None and key in ("k", "v", "ckv", "kr") and len(shape) >= 3:
            # sequence parallelism over the cache when batch can't shard
            if shape[batch_dim + 1] % sizes["data"] == 0:
                seq_ax = "data"
        if key in ("k", "v"):
            if len(shape) == 5:   # [L, B, S, H, dh] (enc-dec stacks)
                h_ax = "model" if shape[3] % M == 0 else None
                d_ax = "model" if h_ax is None and shape[4] % M == 0 else None
                return (None, b_ax, seq_ax, h_ax, d_ax)
            h_ax = "model" if shape[2] % M == 0 else None
            d_ax = "model" if h_ax is None and shape[3] % M == 0 else None
            return (b_ax, seq_ax, h_ax, d_ax)
        if key in ("ckv", "kr"):
            return (b_ax, seq_ax, None)
        if key == "S":            # rwkv state [B, H, dk, dv]
            return (b_ax, "model" if shape[1] % M == 0 else None, None, None)
        if key in ("tm_prev", "cm_prev"):
            return (b_ax, None)
        if key == "h":            # rglru [B, lru]
            return (b_ax, "model" if shape[1] % M == 0 else None)
        if key == "conv":         # [B, K-1, lru]
            return (b_ax, None, "model" if shape[2] % M == 0 else None)
        return (None,) * len(shape)

    def walk(tree, key):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        return leaf_spec(key, tuple(getattr(tree, "shape", ())))

    return walk(cache, None)


def abstract_cache(cfg, model, batch, seq_len, dtype=torch.bfloat16):
    """The cache's tensors on the ``meta`` device: shapes and dtypes, no
    storage (the reference's ``eval_shape`` of ``init_cache``)."""
    from ..models import encdec, transformer
    make = encdec.encdec_cache if cfg.encoder is not None \
        else transformer.init_cache
    return make(cfg, batch, seq_len, dtype, device="meta")


def fake_mesh(shape: tuple, axes: tuple):
    """A ``fake`` process group of world ``prod(shape)`` as this process's
    default group, and a mesh of ``shape`` and ``axes`` over it. A fake
    group of another size is replaced; any other default group is
    refused."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = math.prod(shape)
    if tdist.is_initialized():
        if tdist.get_backend() != "fake":
            raise RuntimeError("the dry run's fake process group cannot share "
                               "a process with another default group ("
                               f"{tdist.get_backend()}); run it in its own")
        if tdist.get_world_size() != world:
            tdist.destroy_process_group()
    if not tdist.is_initialized():
        tdist.init_process_group("fake", store=FakeStore(), rank=0,
                                 world_size=world)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def fake_world(multi_pod: bool = False):
    """The production mesh (16x16, or 2x16x16 with ``multi_pod``) over a
    fake group of its world (``fake_mesh``)."""
    from .mesh import PRODUCTION_MESHES
    return fake_mesh(*PRODUCTION_MESHES[multi_pod])


def serve_count(cfg, mesh_shape: tuple, batch: int, prompt: int,
                max_seq: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """``hlo_cost``'s count of one sharded prefill on fake tensors: ``cfg``
    with ``dtype`` weights on a ("data", "model") mesh of ``mesh_shape``
    over a fake group, ``batch`` x ``prompt`` tokens into caches of
    ``max_seq`` positions in f32 (as ``ServeEngine`` makes them). The
    count of the same prefill run for real (the kernel launched) must
    equal it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..distributed import make_dist
    from ..models import zoo
    from .hlo_cost import Counter
    mesh = fake_mesh(mesh_shape, ("data", "model"))
    with FakeTensorMode():
        model = zoo.build(cfg, device=mesh.device_type, dtype=dtype,
                          dist=make_dist(mesh))
        cache = model.init_cache(batch, max_seq, dtype=torch.float32)
        tokens = torch.zeros((batch, prompt), dtype=torch.int64,
                             device=mesh.device_type)
        with torch.no_grad(), Counter() as c:
            model.prefill({"tokens": tokens}, cache)
    return c.result()


def _local_bytes(tree) -> int:
    """Bytes of one rank's shards of the tensors in ``tree``."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: dict | None = None):
    """Returns (run, meta, cfg, shape): ``run()`` runs the cell's step once
    and returns (its arguments, its outputs). Call it, and this, under
    ``FakeTensorMode`` over ``fake_world``'s group: the parameters,
    optimizer state, caches and batch are made here as DTensors of fake
    shards."""
    from ..distributed import make_dist
    from ..models import zoo
    from ..train import AdamWConfig, adamw_init, make_train_step
    from .roofline import active_params
    cfg = configs.get(arch)
    _driver_keys = ("microbatches", "no_train_sp", "param_dtype")
    if overrides:
        cfg_over = {k: v for k, v in overrides.items() if k not in _driver_keys}
        if cfg_over:
            cfg = cfg.scaled(**cfg_over)
    shape = SHAPES[shape_name]
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():      # the mesh reads its rank map
        mesh = fake_world(multi_pod)
    sizes = mesh_axes(mesh)
    seq_sharded = (shape.kind == "decode"
                   and shape.global_batch < sizes["data"])
    train_sp = (shape.kind in ("train", "prefill")
                and shape.seq_len % sizes["model"] == 0
                and not (overrides or {}).get("no_train_sp"))
    dist = make_dist(mesh, seq_sharded=seq_sharded,
                     train_seq_sharded=train_sp)
    # training uses fp32 master weights; serving cells may opt into bf16
    # weights (the reference's ``param_dtype`` override)
    param_dtype = getattr(torch, (overrides or {}).get("param_dtype",
                                                       "float32"))
    model = zoo.build(cfg, device=mesh.device_type, dtype=param_dtype,
                      dist=dist)
    params = list(model.parameters())
    B = shape.global_batch
    dev = mesh.device_type

    def tokens(S):
        return torch.zeros((B, S), dtype=torch.int64, device=dev)

    batch = {}
    if cfg.encoder is not None:
        batch["frames"] = torch.zeros((B, cfg.encoder.seq, cfg.d_model),
                                      dtype=torch.bfloat16, device=dev)

    if shape.kind == "train":
        batch["tokens"] = tokens(shape.seq_len + 1)
        # microbatch so each accumulation step sees <= ~16Ki tokens per data
        # shard, as the reference does
        data_shards = sizes.get("data", 1) * sizes.get("pod", 1)
        tokens_per_shard = B * shape.seq_len // data_shards
        mb = 1
        for cand in (1, 2, 4, 8, 16):
            if B % cand == 0 and tokens_per_shard // cand > 16384:
                mb = cand * 2 if B % (cand * 2) == 0 else cand
        mb = (overrides or {}).get("microbatches", mb)
        opt = adamw_init(model)
        step = make_train_step(model, AdamWConfig(), microbatches=mb,
                               device=dev)

        def run():
            stats = step(opt, batch)
            return (params, opt, batch), (params, opt, stats)
    else:
        cache = model.init_cache(B, shape.seq_len)
        if shape.kind == "prefill":
            batch["tokens"] = tokens(shape.seq_len)

            def run():
                with torch.no_grad():
                    return ((params, batch, cache),
                            model.prefill(batch, cache))
        else:
            # one step at the cache's last position (every slot counts)
            cache["pos"].fill_(shape.seq_len - 1)
            tok = tokens(1)

            def run():
                with torch.no_grad():
                    return ((params, cache, tok),
                            model.decode_step(cache, tok))

    meta = {"arch": cfg.name, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "n_devices": int(mesh.size()),
            "n_params": model.n_params,
            "n_params_active": active_params(cfg, model.n_params)}
    return run, meta, cfg, shape


def should_skip(arch: str, shape_name: str) -> str | None:
    cfg = configs.get(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention family: long_500k requires sub-quadratic "
                "attention (see DESIGN.md §Arch-applicability)")
    return None


def count(run) -> dict:
    """``run()`` under ``hlo_cost.Counter``: its counts, and the memory of
    one rank: its arguments' and outputs' shard bytes and, as ``temp``,
    the peak bytes held by storages the step made."""
    from .hlo_cost import Counter
    with Counter() as counter:
        args, outs = run()
    hc = counter.result()
    hc["memory"] = {"argument_size_in_bytes": _local_bytes(args),
                    "output_size_in_bytes": _local_bytes(outs),
                    "temp_size_in_bytes": hc["peak_live_bytes"]}
    return hc


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = ARTIFACT_DIR, overrides: dict | None = None,
             tag: str = "") -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from .roofline import model_flops, parse_collectives, roofline_terms
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_tag}
    skip = should_skip(arch, shape_name)
    if skip:
        rec.update(status="skipped", reason=skip)
        _save(rec, out_dir, arch, shape_name, mesh_tag, tag)
        return rec
    t0 = time.time()
    try:
        with FakeTensorMode():
            run, meta, cfg, shape = build_cell(arch, shape_name, multi_pod,
                                               overrides)
            rec.update(meta)
            t_build = time.time() - t0
            hc = count(run)
        t_trace = time.time() - t0 - t_build
        flops = hc["flops"]
        coll = parse_collectives(hc)
        mf = model_flops(cfg, shape, meta["n_params"], meta["n_params_active"])
        mf_per_dev = mf / meta["n_devices"]
        terms = roofline_terms(flops, hc["bytes"], coll["total_bytes"])
        rec.update(
            status="ok",
            build_s=round(t_build, 1), trace_s=round(t_trace, 1),
            flops_per_device=flops, bytes_per_device=hc["bytes"],
            collectives=coll, memory=hc["memory"], n_ops=hc["n_ops"],
            model_flops_total=mf, model_flops_per_device=mf_per_dev,
            useful_flops_ratio=(mf_per_dev / flops) if flops else None,
            roofline=terms,
        )
    except Exception as e:   # a cell's failure is its record; the run goes on
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _save(rec, out_dir, arch, shape_name, mesh_tag, tag)
    return rec


def _save(rec, out_dir, arch, shape_name, mesh_tag, tag=""):
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fn = f"{arch.replace('.', '_')}__{shape_name}__{mesh_tag}{suffix}.json"
    with open(os.path.join(out_dir, fn), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    archs = list(configs.ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failed = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, out_dir=args.out)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" compute={r['compute_s']:.3e}s "
                             f"mem={r['memory_s']:.3e}s coll={r['collective_s']:.3e}s"
                             f" dom={r['dominant']} trace={rec['trace_s']}s")
                    print(f"[mem] {rec['memory']}")
                elif status == "error":
                    failed += 1
                    extra = " " + rec["error"][:200]
                elif status == "skipped":
                    extra = " " + rec["reason"][:80]
                print(f"{arch:18s} {shape:12s} {rec['mesh']:8s} {status}{extra}",
                      flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
