"""Plain PyTorch version of the page-unpack kernel.

It reads the same staging buffer (``staging.py``) and writes the same bytes:
for each page, value j is the code of its j-th row not deleted (``j`` plus
the count of its skips ``d_i - i`` at or below ``j``), that is bits
``row * width`` to ``row * width + width - 1`` of the page's LSB-first
stream, taken as the kernel takes it from the 64-bit word holding the first
bit and the next one; a dictionary page's value is ``dict[code]``, or 0
for a code at or past ``nuniq``; each value stored as its low ``out_size``
bytes. PyTorch's int64 shifts stand in for the kernel's unsigned ones: a
right shift is masked to a logical one, and a left shift by 64 gives 0.
"""

from __future__ import annotations

import torch

from .staging import descriptors

_INTS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _codes(staging: torch.Tensor, bits_offset: int, row: torch.Tensor,
           width: int) -> torch.Tensor:
    """The ``width``-bit codes of ``row`` (int64, the bits as uint64)."""
    if width == 0 or not len(row):
        return torch.zeros_like(row)
    bit = row * width
    k, s = bit >> 6, bit & 63
    last = int((bit.max() + width - 1) >> 6)
    words = staging[bits_offset:bits_offset + 8 * (last + 1)].view(torch.int64)
    v = (words[k] >> s) & ((1 << (64 - s)) - 1)
    hi = words[torch.clamp(k + 1, max=last)] << (64 - s)
    v |= torch.where(s + width > 64, hi, torch.zeros_like(hi))
    return v if width == 64 else v & ((1 << width) - 1)


def page_unpack_ref(staging: torch.Tensor, n_pages: int,
                    out: torch.Tensor) -> None:
    """staging: uint8 buffer of ``staging.pack_pages``; out: uint8 bytes
    on the same device, written in place at each page's ``out_offset``."""
    dev = staging.device
    for d in descriptors(staging, n_pages):
        rows, size = int(d["rows"]), int(d["out_size"])
        if not rows:
            continue
        row = torch.arange(rows, dtype=torch.int64, device=dev)
        n_deleted, at = int(d["n_deleted"]), int(d["skip_offset"])
        if n_deleted:
            skip = staging[at:at + 4 * n_deleted].view(torch.int32).long()
            row += torch.searchsorted(skip, row, right=True)
        code = _codes(staging, int(d["bits_offset"]), row, int(d["width"]))
        nuniq = int(d["nuniq"])
        if nuniq < 0:             # fixed_bit_width: the code's low bytes
            val = code.view(torch.uint8).view(rows, 8)[:, :size]
        else:
            at = int(d["dict_offset"])
            masked = (code < 0) | (code >= nuniq)
            entries = staging[at:at + nuniq * size].view(_INTS[size])
            val = torch.zeros(rows, dtype=_INTS[size], device=dev)
            if nuniq:
                idx = torch.where(masked, torch.zeros_like(code), code)
                val = torch.where(masked, val, entries[idx])
        at = int(d["out_offset"])
        out[at:at + rows * size] = val.contiguous().view(torch.uint8) \
            .reshape(-1)
