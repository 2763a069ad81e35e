"""AdamW with a warmup-cosine schedule and global-norm clipping, ported
from ``repro.train.optimizer``: the reference's formula, not
``torch.optim.AdamW`` (whose clip divides by ``norm + 1e-6`` where the
reference divides by ``max(norm, 1e-9)``).

Parameters and state are mappings ``{port parameter name: tensor}`` (a
``Model`` stands for its ``named_parameters()``). The state mirrors them:
``{"m": {...}, "v": {...}, "step": int32 0-d tensor}``, the moments in f32.
``adamw_update`` updates parameters and state in place. The step, the
schedule and the bias corrections are f32 tensors on the parameters'
device, so a step never waits for the card.

DTensor parameters (a sharded model) keep DTensor moments with their
placements. The update runs on each rank's local shards, after each
gradient is redistributed to its parameter's placements; the global norm
counts every entry once (``global_norm``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from ..distributed.collectives import mesh_sum


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def named(params) -> dict[str, torch.Tensor]:
    """A ``Model`` (or any module) as ``{name: parameter}``; a mapping as
    it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warmup, then cosine down
    to ``min_lr_frac * lr`` at ``total_steps``; f32."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict:
    """Zero moments (f32) for every parameter, and step 0 (int32)."""
    p = named(params)
    device = next(iter(p.values())).device

    def zeros():
        return {k: torch.zeros_like(x, dtype=torch.float32).detach()
                for k, x in p.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in f32 (0-d). DTensors
    count each entry once: a rank adds its shard's squares only where it is
    the first of the shard's replicas (coordinate 0 on each mesh dim that
    does not shard the tensor), and one all-reduce over the mesh sums the
    ranks' totals."""
    total, mesh = None, None
    for x in tensors:
        if isinstance(x, DTensor):
            mesh = x.device_mesh
            if not all(isinstance(p, Shard) or c == 0 for p, c in
                       zip(x.placements, mesh.get_coordinate())):
                continue
            if any(p.is_partial() for p in x.placements):
                raise ValueError("global_norm of a partial sum")
            x = x.to_local()
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    if mesh is not None:
        if total is None:
            total = torch.zeros((), device=mesh.device_type)
        total = mesh_sum(total, mesh)
    return torch.sqrt(total)


def placed_like(g, p):
    """Gradient ``g`` with parameter ``p``'s placements (DTensors)."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig) -> dict:
    """One AdamW step from ``grads`` ({name: tensor}): clip by the global
    norm, then update ``params`` and ``state`` in place. Weight decay
    applies to every parameter, norms and embedding included. Returns
    ``{"grad_norm", "lr"}`` (0-d f32 tensors)."""
    params = named(params)
    grads = {k: placed_like(grads[k], p) for k, p in params.items()}
    state["step"] += 1
    step = state["step"].float()
    gnorm = global_norm(grads[k] for k in params)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, state["step"])
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    for k, p in params.items():
        p = _local(p)
        g = _local(grads[k]).float() * scale
        m, v = _local(state["m"][k]), _local(state["v"][k])
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mhat = m / bc1
        vhat = v / bc2
        p32 = p.float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return {"grad_norm": gnorm, "lr": lr}
