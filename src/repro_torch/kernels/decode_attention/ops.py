"""Public wrapper of the decode-attention kernel: ``decode_attention``, one
decode step's query over a layer's KV cache at the position held on the
card. Each call launches the kernel (adding one to
``decode_attention.launches`` and to the counter
``bullion.attn.decode_kernel_calls``, which a replayed CUDA graph's steps
count too). It runs on CUDA alone, and nothing falls back from it: a
device, shape or dtype it does not take raises. The plain version is
``decode_attention_ref``.
"""

from __future__ import annotations

import threading

import torch

from ...obs import metrics as _metrics
from .kernel import decode_attention_fwd

_launch_lock = threading.Lock()


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """q [B, 1, H, D] over the cache k, v [B, S, Hkv, D] -> [B, 1, H, D] in
    q's dtype. ``pos`` is the step's position, a 0-d int64 tensor on q's
    device, already written to its slot (``pos``, or ``pos % S`` in a
    rolling buffer of ``window``); the valid slots are 0 .. min(pos, S - 1).
    A rolling buffer holds at most ``window`` slots."""
    if window and k.shape[1] > window:
        raise ValueError(f"a rolling buffer of {k.shape[1]} slots is longer "
                         f"than its window {window}")
    out = decode_attention_fwd(q, k, v, pos)
    with _launch_lock:
        decode_attention.launches += 1
    _metrics.counter("bullion.attn.decode_kernel_calls").inc()
    return out


decode_attention.launches = 0
