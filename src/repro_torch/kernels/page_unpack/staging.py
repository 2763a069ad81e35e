"""Host packing of the pages of one page-unpack launch
(``csrc/page_unpack.cu`` ``page_unpack_launch``).

One staging buffer carries a launch: a table of page descriptors
(``DESC_DTYPE``, the C struct ``PageDesc``) at its head, then each page's
packed stream, its dictionary and its deleted rows (as ``skip_i = d_i -
i``, the kept rows before the i-th deleted one), each at a 16-byte-aligned
offset (a stream's region is whole 64-bit words, since the kernel reads
words). The values go to ``out_offset`` bytes from the base of the output
buffer, which the caller lays out. A page takes one block for each
``BLOCK_BYTES`` of whole 16-byte output vectors, and at least one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

DESC_DTYPE = np.dtype([("bits_offset", "<i8"), ("dict_offset", "<i8"),
                       ("nuniq", "<i8"), ("skip_offset", "<i8"),
                       ("out_offset", "<i8"), ("rows", "<i8"),
                       ("block_start", "<i8"), ("width", "<i4"),
                       ("out_size", "<i4"), ("n_deleted", "<i4"),
                       ("pad", "<i4")])
BLOCK_BYTES = 16384          # csrc/page_unpack.cu kBlockBytes
ALIGN = 16


@dataclasses.dataclass
class Page:
    """One page of a launch: its LSB-first stream of ``width``-bit codes
    (``numeric.pack_bits``), and where and how its values land."""

    packed: memoryview | bytes
    width: int
    rows: int                        # values out: the rows not deleted
    out_size: int                    # bytes a value
    dictionary: Optional[np.ndarray] = None   # entries of out_size bytes
    deleted: Optional[np.ndarray] = None      # rows the values skip, rising
    out_offset: int = 0              # bytes from the output buffer's base


@dataclasses.dataclass(frozen=True)
class Layout:
    desc: np.ndarray                 # DESC_DTYPE [n_pages]
    nbytes: int
    n_blocks: int

    @property
    def n_pages(self) -> int:
        return len(self.desc)

    @property
    def moved_bytes(self) -> int:
        """The least a launch moves: each page's packed codes, dictionary
        and deleted rows read once, each value written once."""
        d = self.desc
        stream = ((d["rows"] + d["n_deleted"]) * d["width"] + 7) // 8
        entries = np.maximum(d["nuniq"], 0) * d["out_size"]
        return int((stream + entries + 4 * d["n_deleted"]
                    + d["rows"] * d["out_size"]).sum())


def _align(n: int, to: int = ALIGN) -> int:
    return -(-n // to) * to


def blocks(rows: int, out_size: int, out_offset: int) -> int:
    """Blocks of one page: its whole 16-byte vectors after the head (the
    values before the first 16-byte boundary), as the kernel cuts them."""
    head = min(((ALIGN - out_offset % ALIGN) % ALIGN) // out_size, rows)
    vecs = (rows - head) // (ALIGN // out_size)
    return max(1, -(-vecs * ALIGN // BLOCK_BYTES))


def _regions(page: Page) -> tuple[int, int, int]:
    """Bytes of a page's stream, dictionary and skips in the buffer."""
    words = -(-len(page.packed) // 8) * 8
    dict_bytes = 0 if page.dictionary is None else page.dictionary.nbytes
    skip_bytes = 0 if page.deleted is None else 4 * len(page.deleted)
    return _align(words), _align(dict_bytes), _align(skip_bytes)


def staging_bytes(pages: Sequence[Page]) -> int:
    """Size of the staging buffer of ``pages`` (their out_offsets aside)."""
    return _align(len(pages) * DESC_DTYPE.itemsize) + sum(
        sum(_regions(p)) for p in pages)


def layout_pages(pages: Sequence[Page]) -> Layout:
    """The descriptor table of ``pages``, at their out_offsets."""
    rows = []
    pos, block = _align(len(pages) * DESC_DTYPE.itemsize), 0
    for p in pages:
        if not 0 <= p.width <= 64 or p.out_size not in (1, 2, 4, 8) \
                or p.out_offset % p.out_size:
            raise ValueError(f"page of width {p.width}, {p.out_size}-byte "
                             f"values at byte {p.out_offset}")
        bits, dict_bytes, skip_bytes = _regions(p)
        n_deleted = 0 if p.deleted is None else len(p.deleted)
        rows.append((pos,
                     pos + bits if p.dictionary is not None else 0,
                     -1 if p.dictionary is None else len(p.dictionary),
                     pos + bits + dict_bytes if n_deleted else 0,
                     p.out_offset, p.rows, block, p.width, p.out_size,
                     n_deleted, 0))
        pos += bits + dict_bytes + skip_bytes
        block += blocks(p.rows, p.out_size, p.out_offset)
    return Layout(np.array(rows, DESC_DTYPE), pos, block)


def write_pages(host: np.ndarray, layout: Layout,
                pages: Sequence[Page]) -> None:
    """Fill ``host`` (uint8, at least ``layout.nbytes``) with the table and
    the pages' regions; a stream's last word is zero past its bytes."""
    desc = layout.desc
    host[:desc.nbytes] = desc.view(np.uint8)
    for p, at, dict_at, skip_at in zip(pages, desc["bits_offset"].tolist(),
                                       desc["dict_offset"].tolist(),
                                       desc["skip_offset"].tolist()):
        n = len(p.packed)
        host[at:at + n] = np.frombuffer(p.packed, np.uint8)
        host[at + n:at + -(-n // 8) * 8] = 0
        if p.dictionary is not None:
            host[dict_at:dict_at + p.dictionary.nbytes] = \
                p.dictionary.view(np.uint8)
        if p.deleted is not None and len(p.deleted):
            skip = np.asarray(p.deleted, np.int64) - np.arange(len(p.deleted))
            host[skip_at:skip_at + 4 * len(skip)] = skip.astype(
                np.int32).view(np.uint8)


def pack_pages(pages: Sequence[Page], *,
               pin: bool = False) -> tuple[torch.Tensor, Layout]:
    """``pages`` -> one staging buffer on the host (page-locked when
    ``pin``) and its layout."""
    layout = layout_pages(pages)
    buffer = torch.empty(layout.nbytes, dtype=torch.uint8, pin_memory=pin)
    write_pages(buffer.numpy(), layout, pages)
    return buffer, layout


def descriptors(staging: torch.Tensor, n_pages: int) -> np.ndarray:
    """The descriptor table at the head of a staging buffer (on any
    device), as a NumPy record array."""
    head = staging[:n_pages * DESC_DTYPE.itemsize].cpu().numpy()
    return head.view(DESC_DTYPE)
