"""Public wrapper of the range-filter kernel.

``range_mask`` takes the JAX wrapper's ``[C, N]`` columns and ``[C]``
bounds (``repro.kernels.filter.ops``) as tensors and returns a bool ``[N]``
mask on their device. A CUDA tensor launches the kernel (and adds one to
``range_mask.launches``); a CPU tensor takes the plain version,
``range_mask_ref``. Nothing falls back from the kernel, and nothing is
padded: the kernel masks the ragged tail itself.
"""

from __future__ import annotations

import threading

import torch

from ... import resolve_device
from .kernel import range_mask_fwd
from .ref import range_mask_ref


_launch_lock = threading.Lock()


def _count_launch() -> None:
    """One launch more; the read path launches from a thread pool."""
    with _launch_lock:
        range_mask.launches += 1


def range_mask(cols: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, *,
               device=None) -> torch.Tensor:
    """cols: f32[C, N] (any strides); lo, hi: f32[C] -> bool[N].

    ``device`` defaults to ``cuda`` (raises where CUDA is absent); the
    tensors must lie on it."""
    dev = resolve_device(device)
    if any(t.device.type != dev.type for t in (cols, lo, hi)):
        raise ValueError(f"tensors on {cols.device}, {lo.device}, "
                         f"{hi.device}; asked for {dev}")
    if dev.type == "cpu":
        return range_mask_ref(cols, lo, hi)
    if dev.type != "cuda":
        raise ValueError(f"no range-filter path for device {dev}")
    out = torch.empty(cols.shape[-1], dtype=torch.uint8, device=cols.device)
    if out.numel():
        range_mask_fwd(cols, lo.contiguous(), hi.contiguous(), out)
        _count_launch()
    return out.view(torch.bool)


range_mask.launches = 0
