"""Host packing of a column list for the column-list dequant body
(``csrc/dequant.cu`` ``dequant_columns_launch``).

One staging buffer carries a launch: a table of ``n_cols`` column
descriptors (``DESC_DTYPE``, the C struct ``ColumnDesc``) at its head, then
each column's codes at a 16-byte-aligned offset. So the table rides the
same copy to the card as the codes and has no width limit. Each column's
output sits at a 16-byte-aligned offset of one float32 buffer. Columns are
cut into tiles of ``TILE_BYTES`` of codes; a descriptor holds the first
tile of its column, and the launch has one block a tile.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

DESC_DTYPE = np.dtype([("code_offset", "<i8"), ("out_offset", "<i8"),
                       ("rows", "<i8"), ("tile_start", "<i8"),
                       ("scale", "<f8"), ("zero", "<f8"), ("q_type", "<i4"),
                       ("pad", "<i4", (3,))])
TILE_BYTES = 8192             # csrc/dequant.cu kTileBytes
ALIGN = 16
# code dtype -> the kernel's QType; uint16 is a bf16 bit pattern
CODE_TYPES = {np.dtype(np.int8): 0, np.dtype(np.uint8): 1,
              np.dtype(np.int16): 2, np.dtype(np.uint16): 3}
CODE_DTYPES = {v: k for k, v in CODE_TYPES.items()}


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where each column of a launch lies: its descriptor (the buffer's
    head), its codes in the staging buffer and its values in the output."""

    desc: np.ndarray                # DESC_DTYPE [n_cols]
    nbytes: int                     # of the staging buffer
    n_tiles: int
    n_out: int                      # float32 elements of the output

    @property
    def n_cols(self) -> int:
        return len(self.desc)

    @property
    def code_offsets(self) -> tuple[int, ...]:
        return tuple(int(o) for o in self.desc["code_offset"])

    @property
    def out_offsets(self) -> tuple[int, ...]:
        return tuple(int(o) for o in self.desc["out_offset"])

    @property
    def rows(self) -> tuple[int, ...]:
        return tuple(int(r) for r in self.desc["rows"])


@dataclasses.dataclass(frozen=True)
class Packed(Layout):
    buffer: torch.Tensor = None     # uint8 [nbytes] on the host


def _align(n: int, to: int = ALIGN) -> int:
    return -(-n // to) * to


def layout_columns(columns: Sequence[tuple[int, np.dtype]],
                   params: Sequence[tuple[float, float]]) -> Layout:
    """The layout of 1-D code columns given as ``(rows, dtype)`` (int8,
    uint8, int16, or uint16 bf16 bits), with their float64 ``(scale,
    zero)``."""
    if len(columns) != len(params):
        raise ValueError(f"{len(columns)} columns, {len(params)} (scale, "
                         "zero)")
    desc = np.zeros(len(columns), DESC_DTYPE)
    pos, out, tile = _align(desc.nbytes), 0, 0
    for d, (rows, dtype), (scale, zero) in zip(desc, columns, params):
        dtype = np.dtype(dtype)
        if dtype not in CODE_TYPES:
            raise ValueError(f"codes {dtype}: need int8, uint8, int16 or "
                             "uint16")
        nbytes = rows * dtype.itemsize
        d["code_offset"], d["out_offset"], d["rows"] = pos, out, rows
        d["tile_start"], d["scale"], d["zero"] = tile, scale, zero
        d["q_type"] = CODE_TYPES[dtype]
        pos = _align(pos + nbytes)
        out += _align(rows, ALIGN // 4)
        tile += -(-nbytes // TILE_BYTES)
    return Layout(desc, pos, tile, out)


def pack_columns(codes: Sequence, params: Sequence[tuple[float, float]], *,
                 pin: bool = False) -> Packed:
    """1-D code arrays (NumPy or CPU tensors of int8/uint8/int16, or uint16
    bf16 bits) and their float64 ``(scale, zero)`` -> one staging buffer,
    page-locked when ``pin``. Gaps left by the alignment are not written."""
    arrays = [c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
              for c in codes]
    for a in arrays:
        if a.ndim != 1:
            raise ValueError(f"codes {a.dtype}{list(a.shape)}: need 1-D")
    layout = layout_columns([(a.size, a.dtype) for a in arrays], params)
    buffer = torch.empty(layout.nbytes, dtype=torch.uint8, pin_memory=pin)
    host = buffer.numpy()
    host[:layout.desc.nbytes] = layout.desc.view(np.uint8)
    for off, a in zip(layout.code_offsets, arrays):
        np.copyto(host[off:off + a.nbytes].view(a.dtype), a)
    return Packed(**{f.name: getattr(layout, f.name)
                     for f in dataclasses.fields(Layout)}, buffer=buffer)


def descriptors(staging: torch.Tensor, n_cols: int) -> np.ndarray:
    """The descriptor table at the head of a staging buffer (on any
    device), as a NumPy record array."""
    head = staging[:n_cols * DESC_DTYPE.itemsize].cpu().numpy()
    return head.view(DESC_DTYPE)
