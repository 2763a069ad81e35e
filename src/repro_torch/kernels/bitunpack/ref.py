"""Plain versions of the BP32 bit-planar pack and unpack.

Layout ("BP32", ported from ``repro.kernels.bitunpack.ref``): values are
grouped in 32s; plane word j of a group holds bit j of all 32 values (bit i
of word j == bit j of value i). A width-w column stores w uint32 words per
32 values. ``pack_bp32_ref`` is the host packer in NumPy, a copy of the
reference's; ``bitunpack_ref`` is the plain PyTorch unpack beside the
kernel.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_bp32_ref(values: np.ndarray, width: int) -> np.ndarray:
    """values: uint32[N] (N % 32 == 0, values < 2**width) -> uint32[N//32, w]."""
    assert values.ndim == 1 and len(values) % 32 == 0
    v = values.astype(np.uint32).reshape(-1, 32)
    planes = np.zeros((v.shape[0], width), np.uint32)
    for j in range(width):
        bits = (v >> np.uint32(j)) & np.uint32(1)          # [G, 32]
        planes[:, j] = (bits << np.arange(32, dtype=np.uint32)).sum(
            axis=1, dtype=np.uint32)
    return planes


def bitunpack_ref(planes: torch.Tensor, width: int) -> torch.Tensor:
    """planes: uint32[G, w] -> uint32[G*32]. Works on an int64 copy:
    PyTorch has no shifts on uint32 on the CPU."""
    p = planes.to(torch.int64)
    lanes = torch.arange(32, dtype=torch.int64, device=planes.device)
    out = torch.zeros((p.shape[0], 32), dtype=torch.int64, device=planes.device)
    for j in range(width):
        out |= ((p[:, j:j + 1] >> lanes) & 1) << j
    return out.reshape(-1).to(torch.uint32)
