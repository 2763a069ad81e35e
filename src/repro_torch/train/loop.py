"""Training step factory, ported from ``repro.train.loop``: loss -> grads
-> AdamW, with optional microbatch gradient accumulation and an optional
gradient transform (``train.compression``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import resolve_device
from ..models.zoo import as_device_tensor
from ..obs import trace as _trace
from .optimizer import AdamWConfig, placed_like, adamw_update


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    grad_transform: Optional[Callable] = None, device=None):
    """Make ``model`` trainable and return ``train_step(opt_state, batch)``,
    which updates the model's parameters and ``opt_state`` in place and
    returns ``{"loss", "grad_norm", "lr"}`` (0-d tensors on the model's
    device). ``batch``: ``{"tokens": [B, S+1]}``, a tensor or array.

    ``microbatches = n > 1`` splits every entry of the batch as
    ``[n, B/n, ...]``, sums the loss and the grads (f32) over the
    microbatches and scales both by 1/n, as the reference's scan does.
    ``device`` (default ``cuda``; raises where CUDA is absent) is where the
    model must lie. A sharded model (DTensor parameters) takes its loss and
    gradients in ``model.sharded_ops()``; each gradient comes back with
    its parameter's placements."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"the model lies on {model.device}; asked for {dev}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be at least 1, got {microbatches}")
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def value_and_grad(batch):
        with model.sharded_ops():
            with _trace.device_span("train.forward", cat="train"):
                loss = model.loss(batch)
            # the layers' recompute (each a checkpoint) runs in here
            with _trace.device_span("train.backward", cat="train"):
                grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), {k: placed_like(g, params[k])
                               for k, g in zip(params, grads)}

    def grads_of(batch):
        batch = {k: as_device_tensor(x, model.device)
                 for k, x in batch.items()}
        if microbatches == 1:
            return value_and_grad(batch)
        n = microbatches
        if any(x.shape[0] % n for x in batch.values()):
            raise ValueError(f"batch of {batch['tokens'].shape[0]} does not "
                             f"split into {n} microbatches")
        split = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])
                 for k, x in batch.items()}
        total = torch.zeros((), device=model.device)
        acc = {k: torch.zeros_like(p, dtype=torch.float32).detach()
               for k, p in params.items()}
        for i in range(n):
            loss, grads = value_and_grad({k: x[i] for k, x in split.items()})
            total += loss
            for k, g in grads.items():
                acc[k] += g
        inv = 1.0 / n
        return total * inv, {k: g * inv for k, g in acc.items()}

    def train_step(opt_state: dict, batch: dict) -> dict:
        loss, grads = grads_of(batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        with _trace.device_span("train.optimizer", cat="train"):
            stats = adamw_update(grads, opt_state, params, opt_cfg)
        return {"loss": loss, **stats}

    return train_step
