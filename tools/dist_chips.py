#!/usr/bin/env python3
"""The port's sharded training step and sharded serving across the cards
of one host: one rank a card over NCCL, llama3.2-1b at full width, built
with ``build(cfg, dist=make_dist(mesh))`` on each mesh of ``--meshes``
("data" x "model"), against the unsharded model on rank 0's card from the
same parameters and batch.

    python3 tools/dist_chips.py [--meshes 2x2 1x4 4x1] [--layers 1 16]
                                [--steps 3]

Serving (B=8 prompts of 512 tokens, 8 new tokens through
``ServeEngine``, caches placed by ``cache_specs``): for each depth and
mesh, one JSON line with ``"serve": true``: the prefill's and a decode
step's ms (host clock around a synchronise, the engine's second run), the
prefill logits' gap to rank 0's unsharded prefill and its bound (2e-2 x
max|ref| + 1e-3, phase serve's), the greedy tokens' equality with the
unsharded engine's, the flash launches a prefill by body. At one layer,
in f32 (the `simt` body: the shards' sums in another order move a logit
by about 1e-6 of its size, so no greedy choice is near enough a tie to
flip), the gap must be within the bound and the tokens equal; at full
depth, in bf16 as served (`wgmma`), the random init amplifies rounding
past it (ROADMAP.md §3) and bf16 near-ties may flip a token, so both are
printed as witnesses beside the times.

For each depth of ``--layers`` and each mesh, one JSON line: the step time
(host clock around a synchronise, the median of steps 2 on), each rank's
flash launches a step by body (the kernel on its local shards under
``local_map``), the loss and the largest parameter gap to the unsharded
step after one step, each rank's peak memory. Then the card's name and
power limit. The world size is the product of each mesh's shape.

At one layer the sharded model is held to the unsharded one before any
step: the loss within ``LOSS_TOL`` and every parameter's gradient within
``GRAD_REL`` of that leaf's largest entry (a misplaced shard, a wrong
kv-head slice or a partial sum counted twice moves a leaf by the order of
its largest entry; reordered f32 sums move it by about 1e-6 of it). At
full depth the random init amplifies
rounding (ROADMAP.md §3), so there the gaps are printed as witnesses, not
held. Non-finite losses, a gap past its bound and launches other than 2 a
layer a step (all ``simt``) fail the run.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

OPT = dict(lr=1e-3, warmup_steps=10, total_steps=100)   # the launcher's
BATCH, SEQ = 8, 512
NEW = 8             # serving: new tokens a prompt
LOSS_TOL = 1e-5     # the loss before any step, sharded against unsharded
GRAD_REL = 1e-3     # a leaf's gradient gap over its largest entry


def _cfg(layers: int, dtype: str = "float32"):
    import repro_torch.configs as configs
    return configs.get("llama3.2-1b").scaled(
        compute_dtype=dtype, segments=((("full:swiglu",), layers),))


def _serve(model, prompts):
    """The engine's second run (the first warms up): (tokens, prefill ms,
    decode ms a step, flash launches by body in that run)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, max_seq=SEQ + NEW, device="cuda")
    eng.generate(prompts, NEW)
    before = dict(flash_attention.launches_by_body)
    out = eng.generate(prompts, NEW)
    by_body = {b: n - before[b]
               for b, n in flash_attention.launches_by_body.items()}
    return (out["tokens"], out["prefill_s"] * 1e3,
            out["decode_s"] * 1e3 / NEW, by_body)


def _prefill_logits(model, prompts):
    from torch.distributed.tensor import DTensor
    with torch.no_grad():
        cache = model.init_cache(BATCH, SEQ + NEW, dtype=torch.float32)
        lg, _ = model.prefill({"tokens": torch.as_tensor(
            prompts, dtype=torch.int64, device="cuda")}, cache)
    return lg.full_tensor() if isinstance(lg, DTensor) else lg


def _serve_meshes(args, rank: int, world: int) -> None:
    """Sharded serving on every mesh against rank 0's unsharded model, one
    JSON line a depth and mesh (rank 0)."""
    from repro_torch.distributed import make_dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.zoo import build
    for layers in args.layers:
        dtype = torch.float32 if layers == 1 else torch.bfloat16
        cfg = _cfg(layers, str(dtype).replace("torch.", ""))
        prompts = np.random.default_rng(args.seed).integers(
            0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
        ref = None
        if rank == 0:
            m0 = build(cfg, device="cuda", dtype=dtype, seed=args.seed)
            ref = (_prefill_logits(m0, prompts).float(), *_serve(m0, prompts))
            del m0
            torch.cuda.empty_cache()
        tdist.barrier()
        for shape in args.meshes:
            mesh = make_test_mesh(*shape)
            model = build(cfg, device="cuda", dtype=dtype, seed=args.seed,
                          dist=make_dist(mesh))
            lg = _prefill_logits(model, prompts).float()
            tokens, prefill_ms, decode_ms, by_body = _serve(model, prompts)
            rows = [None] * world
            tdist.all_gather_object(rows, dict(prefill_ms=prefill_ms,
                                               decode_ms=decode_ms,
                                               by_body=by_body))
            if rank == 0:
                gap = (lg - ref[0]).abs().max().item()
                bound = 2e-2 * ref[0].abs().max().item() + 1e-3
                line = dict(serve=True, mesh=dict(data=shape[0],
                                                  model=shape[1]),
                            n_layers=layers, batch=BATCH, prompt_len=SEQ,
                            new_tokens=NEW, dtype=cfg.compute_dtype,
                            prefill_ms=[r["prefill_ms"] for r in rows],
                            decode_ms_per_step=[r["decode_ms"]
                                                for r in rows],
                            unsharded_prefill_ms=ref[2],
                            unsharded_decode_ms_per_step=ref[3],
                            logit_gap=gap, logit_bound=bound,
                            tokens_equal=bool((tokens == ref[1]).all()),
                            held=layers == 1,
                            flash_launches_by_rank=[r["by_body"]
                                                    for r in rows])
                print(json.dumps(line), flush=True)
                if layers == 1 and not (gap < bound
                                        and line["tokens_equal"]):
                    raise RuntimeError(f"serving on mesh {shape}: {line}")
                want = dict(simt=layers if layers == 1 else 0, mma=0,
                            wgmma=0 if layers == 1 else layers)
                if any(r["by_body"] != want for r in rows):
                    raise RuntimeError(f"serving launches {rows}, "
                                       f"expected {want} a prefill")
            del model
            torch.cuda.empty_cache()
            tdist.barrier()


def _grads(model, tokens) -> tuple[float, dict]:
    """The loss before any step and every parameter's gradient, whole (a
    collective on every rank for a sharded model)."""
    from torch.distributed.tensor import DTensor
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    with model.sharded_ops():
        loss = model.loss({"tokens": tokens})
        grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss), {k: g.full_tensor() if isinstance(g, DTensor) else g
                         for k, g in zip(params, grads)}


def _unsharded(cfg, tokens, seed, hold: bool):
    """Rank 0's unsharded model: (its loss and gradients before any step
    where ``hold``, else None; its loss in the step; the parameters after
    it)."""
    from repro_torch.models.zoo import build
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    m = build(cfg, device="cuda", seed=seed)
    before = _grads(m, tokens) if hold else None
    step = make_train_step(m, AdamWConfig(**OPT), device="cuda")
    loss = float(step(adamw_init(m), {"tokens": tokens})["loss"])
    return before, loss, {k: p.detach().clone()
                          for k, p in m.named_parameters()}


def _sharded(cfg, tokens, seed, shape, steps, hold, ref):
    """One mesh: the gaps before any step where ``hold``, then ``steps``
    sharded steps; this rank's row. ``ref``: rank 0's ``_unsharded``."""
    from repro_torch.distributed import make_dist
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.zoo import build
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    mesh = make_test_mesh(*shape)
    model = build(cfg, device="cuda", seed=seed, dist=make_dist(mesh))
    held = {}
    if hold:
        loss, grads = _grads(model, tokens)
        if ref is not None:
            loss0, grads0 = ref[0]
            rel = {k: ((g - grads0[k]).abs().max()
                       / grads0[k].abs().max()).item()
                   for k, g in grads.items()}
            worst = max(rel, key=rel.get)
            held = dict(loss_before=loss, loss_before_gap=abs(loss - loss0),
                        grad_rel_gap=rel[worst], grad_rel_gap_at=worst)
        del grads
    opt = adamw_init(model)
    step = make_train_step(model, AdamWConfig(**OPT), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    before = dict(flash_attention.launches_by_body)
    losses, ms, gap = [], [], 0.0
    for i in range(steps):
        torch.cuda.synchronize()
        tdist.barrier()
        t0 = time.perf_counter()
        losses.append(float(step(opt, {"tokens": tokens})["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            for name, p in model.named_parameters():
                whole = p.full_tensor()          # every rank: a collective
                if ref is not None:
                    gap = max(gap, (whole - ref[2][name]).abs().max().item())
    by_body = {b: n - before[b]
               for b, n in flash_attention.launches_by_body.items()}
    return dict(losses=losses, step_ms=ms, param_gap=gap, held=held,
                launches_by_body=by_body,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                / 1e9)


def _rank(rank: int, args, store: str) -> None:
    world = math.prod(args.meshes[0])
    torch.cuda.set_device(rank)
    tdist.init_process_group("nccl", store=tdist.FileStore(store, world),
                             rank=rank, world_size=world)
    try:
        _serve_meshes(args, rank, world)
        for layers in args.layers:
            cfg = _cfg(layers)
            hold = layers == 1
            tokens = torch.randint(
                0, cfg.vocab, (BATCH, SEQ + 1),
                generator=torch.Generator().manual_seed(args.seed))
            ref = _unsharded(cfg, tokens, args.seed, hold) if rank == 0 \
                else None
            torch.cuda.empty_cache()
            tdist.barrier()
            for shape in args.meshes:
                row = _sharded(cfg, tokens, args.seed, shape, args.steps,
                               hold, ref)
                rows = [None] * world
                tdist.all_gather_object(rows, row)
                if rank == 0:
                    _report(cfg, shape, layers, ref[1], rows, args.steps,
                            hold)
                torch.cuda.empty_cache()
            del ref
    finally:
        tdist.destroy_process_group()


def _report(cfg, shape, layers, loss0, rows, steps, hold) -> None:
    r0 = rows[0]
    per_step = [{b: n // steps for b, n in r["launches_by_body"].items()}
                for r in rows]
    line = dict(mesh=dict(data=shape[0], model=shape[1]), n_layers=layers,
                d_model=cfg.d_model, batch=BATCH, seq=SEQ, dtype="float32",
                step_ms=[r["step_ms"] for r in rows],
                dist_step_ms=float(np.median(r0["step_ms"][1:])),
                losses=r0["losses"], loss_unsharded=loss0,
                loss_gap=abs(r0["losses"][0] - loss0),
                param_gap=r0["param_gap"], held=hold, **r0["held"],
                loss_tol=LOSS_TOL, grad_rel_tol=GRAD_REL,
                flash_launches_per_step_by_rank=per_step,
                max_memory_allocated_gb=[r["max_memory_allocated_gb"]
                                         for r in rows])
    print(json.dumps(line), flush=True)
    if not all(math.isfinite(x) for r in rows for x in r["losses"]):
        raise RuntimeError(f"non-finite losses on mesh {shape}")
    if hold and not (r0["held"]["loss_before_gap"] < LOSS_TOL
                     and r0["held"]["grad_rel_gap"] < GRAD_REL):
        raise RuntimeError(f"mesh {shape}, {layers} layers: {r0['held']}")
    want = dict(simt=2 * layers, mma=0, wgmma=0)
    if any(p != want for p in per_step):
        raise RuntimeError(f"flash launches a step {per_step}, expected "
                           f"{want} on every rank")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--meshes", nargs="+", default=["2x2", "1x4", "4x1"])
    ap.add_argument("--layers", nargs="+", type=int, default=[1, 16])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    args.meshes = [tuple(int(n) for n in m.split("x")) for m in args.meshes]
    world = math.prod(args.meshes[0])
    if any(math.prod(m) != world for m in args.meshes):
        raise SystemExit(f"meshes {args.meshes} need one world size")
    if torch.cuda.device_count() < world:
        raise SystemExit(f"{world} ranks need {world} cards; "
                         f"{torch.cuda.device_count()} visible")
    from repro_torch.kernels import _build
    _build.load("flash_attention")           # once, before the ranks start
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(args, os.path.join(tmp, "store")),
                           nprocs=world, start_method="spawn")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
