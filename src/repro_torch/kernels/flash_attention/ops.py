"""Public wrappers of the flash-attention kernel.

``flash_attention`` keeps the JAX wrapper's ``[B, H, S, D]`` layout
(``repro.kernels.flash_attention.ops``); ``attention`` is the layout-free
entry the model uses, on ``[B, S, H, D]`` views. A CUDA tensor launches the
kernel (and adds one to ``flash_attention.launches`` and to the launched
body's entry of ``flash_attention.launches_by_body``); a CPU tensor takes
the plain version, ``attention_ref``. Nothing falls back from the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import resolve_device
from .kernel import BODIES, flash_attention_fwd
from .ref import attention_ref


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              kv_len: Optional[int] = None, body: str = "auto"):
    """q: [B, S, H, D], k, v: [B, S, Hkv, D] -> [B, S, H, D] (contiguous).
    Query head h reads kv head h // (H // Hkv); keys at positions >= kv_len
    are masked (kv_len >= 1); scale 1/sqrt(D). ``body``: ``"auto"`` (the
    model's) lets the binding choose the kernel's body by dtype and layout;
    ``"wgmma"``, ``"mma"`` or ``"simt"`` asks for one (CUDA tensors only)."""
    if body != "auto" and body not in BODIES:
        raise ValueError(f"unknown body {body!r}: 'auto' or one of "
                         f"{list(BODIES)}")
    S = q.shape[1]
    kv_len = S if kv_len is None else int(kv_len)
    if kv_len < 1:
        # no live key: the reference would average V, the kernel write 0
        raise ValueError(f"kv_len must be at least 1, got {kv_len}")
    if q.is_cuda:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        used = flash_attention_fwd(q, k, v, out, causal=causal,
                                   window=window, kv_len=kv_len, body=body)
        flash_attention.launches += 1
        flash_attention.launches_by_body[used] += 1
        return out
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")
    if body != "auto":
        raise ValueError(f"body={body!r} names a body of the CUDA kernel; a "
                         "CPU tensor takes the plain version")
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        kv_len=kv_len)
    return out.transpose(1, 2).contiguous()


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
