"""Public wrappers of the flash-attention kernel.

``flash_attention`` keeps the JAX wrapper's ``[B, H, S, D]`` layout
(``repro.kernels.flash_attention.ops``); ``attention`` is the layout-free
entry the model uses, on ``[B, S, H, D]`` views. A CUDA tensor launches the
kernel (and adds one to ``flash_attention.launches``, to the launched
body's entry of ``flash_attention.launches_by_body``, to the window's
entry of ``flash_attention.launches_by_window``, 0 for none, and to the
causal flag's of ``flash_attention.launches_by_causal``); a CPU
tensor takes the plain version, ``attention_ref``. Nothing falls back from
the kernel.

An input that requires grad takes ``attention`` through ``_Attention``, a
``torch.autograd.Function``: its forward is the same launch (or the plain
version on the CPU), its backward the plain ``attention_bwd_ref`` on every
device, since the reference has no backward kernel either. The kernel's
own output carries no graph, so its route raises for such an input that
comes any other way.
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import resolve_device
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


def _forward(q, k, v, causal, window, kv_len, body):
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


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              kv_len: Optional[int] = None, body: str = "auto"):
    """q: [B, S, H, D], k, v: [B, S, Hkv, D] -> [B, S, H, D] (contiguous).
    Query head h reads kv head h // (H // Hkv); keys at positions >= kv_len
    are masked (kv_len >= 1); scale 1/sqrt(D). ``body``: ``"auto"`` (the
    model's) lets the binding choose the kernel's body by dtype and layout;
    ``"wgmma"``, ``"mma"`` or ``"simt"`` asks for one (CUDA tensors only).
    Where an input requires grad (and grad is enabled), the call goes
    through ``_Attention``; the launch is counted each time its forward
    runs, a recompute under checkpointing included."""
    if body != "auto" and body not in BODIES:
        raise ValueError(f"unknown body {body!r}: 'auto' or one of "
                         f"{list(BODIES)}")
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
