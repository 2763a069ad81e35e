"""Public wrappers of the flash-attention kernel.

``flash_attention`` keeps the JAX wrapper's ``[B, H, S, D]`` layout
(``repro.kernels.flash_attention.ops``); ``attention`` is the layout-free
entry the model uses, on ``[B, S, H, D]`` views. A CUDA tensor launches the
kernel (and adds one to ``flash_attention.launches``, to the launched
body's entry of ``flash_attention.launches_by_body``, to the window's
entry of ``flash_attention.launches_by_window``, 0 for none, and to the
causal flag's of ``flash_attention.launches_by_causal``); a CPU
tensor takes the plain version, ``attention_ref``; a fake or meta tensor
(a dry run, ``launch.dryrun``) takes a shape-only route that launches
nothing. The three routes are one custom operator,
``torch.ops.repro_torch.flash_fwd``, with a FLOP formula, so a dispatch
mode counts it alike on each. Nothing falls back from the kernel.

An input that requires grad takes ``attention`` through ``_Attention``, a
``torch.autograd.Function``: its forward is the same launch (or the plain
version on the CPU), its backward the plain ``attention_bwd_ref`` on every
device, since the reference has no backward kernel either. The kernel's
own output carries no graph, so its route raises for such an input that
comes any other way.

DTensor inputs (the sharded training step and prefill) go through
``local_map`` (``local_heads``): each
rank launches the kernel on its local batch rows and query heads, and the
backward flows through ``local_map`` to the same ``_Attention``. Where the
query heads are sharded but the kv heads are replicated (GQA with fewer kv
heads than the model axis), each rank reads the kv heads of its own query
heads: query head h reads kv head h // (H // Hkv) in global numbering.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.flop_counter import register_flop_formula

from ... import resolve_device

from ...distributed.placement import grad_placements, local_range
from .kernel import BODIES, flash_attention_fwd
from .ref import attention_bwd_ref, attention_ref


def _launch(q, k, v, *, causal, window, kv_len, body):
    """The kernel on CUDA tensors [B, S, H, D], counted."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "the flash-attention kernel's output carries no gradient: an "
            "input that requires grad goes through attention(), whose "
            "autograd Function launches the kernel")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    used = flash_attention_fwd(q, k, v, out, causal=causal, window=window,
                               kv_len=kv_len, body=body)
    flash_attention.launches += 1
    flash_attention.launches_by_body[used] += 1
    by_window = flash_attention.launches_by_window
    by_window[window] = by_window.get(window, 0) + 1
    by_causal = flash_attention.launches_by_causal
    by_causal[causal] = by_causal.get(causal, 0) + 1
    return out


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: int, kv_len: int,
               body: str) -> torch.Tensor:
    """The forward as one operator that a dispatch mode sees whole (so a
    cost count, ``launch.hlo_cost``, counts it by ``_flash_flops`` on
    whichever route computes it): the kernel for a CUDA tensor, the plain
    version for a CPU tensor, and ``_shape_only`` for a fake or meta
    tensor."""
    if q.is_cuda:
        return _launch(q, k, v, causal=causal, window=window, kv_len=kv_len,
                       body=body)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")
    if body != "auto":
        raise ValueError(f"body={body!r} names a body of the CUDA kernel; a "
                         "CPU tensor takes the plain version")
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        kv_len=kv_len)
    return out.transpose(1, 2).contiguous()


@_flash_fwd.register_fake
def _shape_only(q, k, v, causal, window, kv_len, body):
    """The output's shape for a fake or meta q (a fake CUDA tensor has
    ``is_cuda`` True, so it must never reach the launch); nothing is
    launched, and a tensor with storage is refused."""
    if not (isinstance(q, FakeTensor) or q.is_meta):
        raise ValueError("the shape-only route of flash attention takes "
                         "fake or meta tensors, not a tensor with storage")
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                 **kwargs) -> int:
    """2·B·H·Sq·Skv·(Dqk + Dv), the masked pairs included: what
    ``attention_ref``'s two products count, so the plain version and the
    kernel count alike."""
    B, S, H, D = q_shape
    return 2 * B * H * S * k_shape[1] * (D + v_shape[-1])


def _forward(q, k, v, causal, window, kv_len, body):
    return torch.ops.repro_torch.flash_fwd(q, k, v, causal, window, kv_len,
                                           body)


class _Attention(torch.autograd.Function):
    """The kernel's forward under autograd, with the plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len, body):
        out = _forward(q, k, v, causal, window, kv_len, body)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = dict(causal=causal, window=window, kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = (x.transpose(1, 2) for x in ctx.saved_tensors)
        grads = attention_bwd_ref(q, k, v, out, dout.transpose(1, 2),
                                  **ctx.mask)
        return (*(g.transpose(1, 2) for g in grads), None, None, None, None)


def local_heads(fn, q, k, v):
    """``fn(ql, kl, vl)`` under ``local_map`` on DTensors q [B, Sq, H, D],
    k, v [B, Skv, Hkv, D]: on each rank's batch rows (q's ``Shard(0)``
    mesh dims) and query heads (q's ``Shard(2)`` mesh dims), the sequences
    and head dims whole, each rank's kl, vl the kv heads of its query
    heads (query head h reads kv head h // (H // Hkv), global numbering).
    The output is placed as q."""
    mesh = q.device_mesh
    qp, kvp = [], []
    for pq, pk in zip(q.placements, k.placements):
        if isinstance(pq, Shard) and pq.dim in (0, 2):
            qp.append(pq)
            # kv heads sharded alike, or replicated: then each rank reads
            # the slice its query heads need
            kvp.append(pk if pq.dim == 2 and pk == pq else
                       Shard(0) if pq.dim == 0 else Replicate())
        else:
            qp.append(Replicate())
            kvp.append(Replicate())
    qp, kvp = tuple(qp), tuple(kvp)
    kv_grad = grad_placements(kvp, qp)
    H, Hkv = q.shape[2], k.shape[2]
    q0, hq = local_range(H, mesh, qp, 2)
    k0, _ = local_range(Hkv, mesh, kvp, 2)
    # the kv heads (local numbering) that local query heads 0..hq-1 read
    idx = [(q0 + h) // (H // Hkv) - k0 for h in range(hq)]

    def local(ql, kl, vl):
        lo, n = idx[0], idx[-1] + 1 - idx[0]
        if hq % n == 0 and idx == [lo + h // (hq // n) for h in range(hq)]:
            kl, vl = kl[:, :, lo:lo + n], vl[:, :, lo:lo + n]
        else:
            sel = torch.tensor(idx, device=kl.device)
            kl, vl = kl.index_select(2, sel), vl.index_select(2, sel)
        return fn(ql, kl, vl)

    return local_map(local, out_placements=[*qp],
                     in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _sharded_attention(q, k, v, causal, window, kv_len, body):
    """``attention`` on DTensors q [B, S, H, D], k, v [B, S, Hkv, D]: the
    kernel on each rank's batch rows and query heads (``local_heads``)."""
    return local_heads(lambda ql, kl, vl: attention(
        ql, kl, vl, causal=causal, window=window, kv_len=kv_len, body=body),
        q, k, v)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              kv_len: Optional[int] = None, body: str = "auto"):
    """q: [B, S, H, D], k, v: [B, S, Hkv, D] -> [B, S, H, D] (contiguous).
    Query head h reads kv head h // (H // Hkv); keys at positions >= kv_len
    are masked (kv_len >= 1); scale 1/sqrt(D). ``body``: ``"auto"`` (the
    model's) lets the binding choose the kernel's body by dtype and layout;
    ``"wgmma"``, ``"mma"`` or ``"simt"`` asks for one (CUDA tensors only).
    Where an input requires grad (and grad is enabled), the call goes
    through ``_Attention``; the launch is counted each time its forward
    runs, a recompute under checkpointing included. DTensor inputs launch
    on each rank's local shards (``_sharded_attention``)."""
    if body != "auto" and body not in BODIES:
        raise ValueError(f"unknown body {body!r}: 'auto' or one of "
                         f"{list(BODIES)}")
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, causal, window, kv_len, body)
    S = q.shape[1]
    kv_len = S if kv_len is None else int(kv_len)
    if kv_len < 1:
        # no live key: the reference would average V, the kernel write 0
        raise ValueError(f"kv_len must be at least 1, got {kv_len}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _Attention.apply(q, k, v, causal, window, kv_len, body)
    return _forward(q, k, v, causal, window, kv_len, body)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: Optional[int] = None, device=None,
                    body: str = "auto"):
    """q: [B, H, S, D], k, v: [B, Hkv, S, D] -> [B, H, S, D].

    ``device`` defaults to ``cuda`` (raises where CUDA is absent); the
    tensors must lie on it. ``body`` as for ``attention``."""
    dev = resolve_device(device)
    if any(x.device.type != dev.type for x in (q, k, v)):
        raise ValueError(f"tensors on {q.device}, {k.device}, {v.device}; "
                         f"asked for {dev}")
    out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, window=window, kv_len=kv_len, body=body)
    return out.transpose(1, 2)


flash_attention.launches = 0
flash_attention.launches_by_body = dict.fromkeys(BODIES, 0)
flash_attention.launches_by_window = {}
flash_attention.launches_by_causal = {}
