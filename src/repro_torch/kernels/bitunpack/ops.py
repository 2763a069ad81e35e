"""Public entry point of the BP32 unpack: ``pack_bp32`` on the host, then
``bitunpack`` on the device.

``bitunpack`` takes uint32 ``[G, w]`` plane words (a tensor, or the NumPy
array ``pack_bp32`` returns) and gives uint32 ``[n_values]`` on the device.
A CUDA tensor launches the kernel (and adds one to ``bitunpack.launches``);
a CPU tensor takes the plain version, ``bitunpack_ref``. Nothing falls back
from the kernel. The kernel needs no padding; ``pack_bp32`` still pads to
the reference's 8192 values, so both packers give the same array.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ... import resolve_device
from .kernel import bitunpack_fwd
from .ref import bitunpack_ref, pack_bp32_ref

PACK_VALUES = 32 * 256     # the reference's GROUPS_PER_BLOCK groups of 32

_launch_lock = threading.Lock()


def _count_launch() -> None:
    with _launch_lock:
        bitunpack.launches += 1


def pack_bp32(values: np.ndarray, width: int) -> np.ndarray:
    """Host-side packing: uint32[N] -> uint32[G, width], N padded with zeros
    to a multiple of 8192 as ``repro.kernels.bitunpack.pack_bp32`` pads."""
    n = len(values)
    pad = (-n) % PACK_VALUES
    v = np.concatenate([values.astype(np.uint32), np.zeros(pad, np.uint32)])
    return pack_bp32_ref(v, width)


def bitunpack(planes, width: int, n_values: int | None = None, *,
              device=None) -> torch.Tensor:
    """uint32[G, width] -> uint32[n_values] (default G * 32) on ``device``.

    ``device`` defaults to ``cuda`` (raises where CUDA is absent). A NumPy
    array is copied there; a tensor must lie on it."""
    dev = resolve_device(device)
    if isinstance(planes, np.ndarray):
        planes = torch.from_numpy(np.ascontiguousarray(planes, np.uint32)).to(dev)
    elif planes.device.type != dev.type:
        raise ValueError(f"planes on {planes.device}; asked for {dev}")
    if planes.dim() != 2 or planes.shape[1] != width or not 1 <= width <= 32 \
            or planes.dtype != torch.uint32:
        raise ValueError(f"planes {planes.dtype}{tuple(planes.shape)} for "
                         f"width {width}: need uint32[G, width], 1..32")
    n = 32 * planes.shape[0] if n_values is None else int(n_values)
    if not 0 <= n <= 32 * planes.shape[0]:
        raise ValueError(f"n_values {n} for {planes.shape[0]} groups of 32")
    if dev.type == "cpu":
        return bitunpack_ref(planes, width)[:n]
    if dev.type != "cuda":
        raise ValueError(f"no bitunpack path for device {dev}")
    out = torch.empty(n, dtype=torch.uint32, device=planes.device)
    if n:
        bitunpack_fwd(planes, width, out)
        _count_launch()
    return out


bitunpack.launches = 0
