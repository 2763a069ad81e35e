"""Gradient compression, ported from ``repro.train.compression``: two
transforms applied to the gradients before the optimizer, each per tensor
(``{name: tensor}`` in and out), as ``make_train_step(grad_transform=)``
takes them.

  * bf16_grads    -- round every gradient through bf16 (what a bf16
                     all-reduce would carry), keeping its dtype.
  * topk_compress -- per-tensor magnitude top-k of (grad + residual), with
                     error feedback: what is not sent is carried in the
                     residual to the next step. A tensor is the
                     reference's: the layers of a block's leaf count as
                     one tensor, stacked, as the reference stores them.

The residual is state beside the optimizer's, ``{name: f32 tensor}``.
"""

from __future__ import annotations

import torch

from ..models.convert import reference_key
from .optimizer import named


def bf16_grads(grads: dict) -> dict:
    return {k: g.to(torch.bfloat16).to(g.dtype) for k, g in grads.items()}


def topk_init(params) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named(params).items()}


def topk_compress(grads: dict, residual: dict,
                  fraction: float = 0.01) -> tuple[dict, dict]:
    """Keep the entries of (grad + residual) whose magnitude reaches the
    k-th largest of their tensor (k = max(1, int(size * fraction)), ties
    kept); the rest feeds back into the residual. Returns (sparse grads,
    new residual)."""
    acc = {k: g.float() + residual[k] for k, g in grads.items()}
    groups: dict[tuple, list[str]] = {}
    for k in acc:
        groups.setdefault(tuple(reference_key(k)[0]), []).append(k)
    sent, left = {}, {}
    for names in groups.values():
        flat = torch.cat([acc[k].abs().reshape(-1) for k in names])
        n = max(1, int(flat.numel() * fraction))
        thresh = torch.topk(flat, n).values[-1]
        for k in names:
            keep = torch.where(acc[k].abs() >= thresh, acc[k], 0.0)
            sent[k], left[k] = keep.to(grads[k].dtype), acc[k] - keep
    return sent, left
