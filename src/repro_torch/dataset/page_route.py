"""The device route of page decode (``executor.decode_group``).

A SCALAR page whose top-level encoding is ``fixed_bit_width``, or
``dictionary`` (its values decoded on the host, whatever their own
encoding: a few hundred entries at most), is decoded on the read path's
device by the page-unpack kernel (``kernels.page_unpack``), with its
deletion vector applied in the kernel's gather. The route is read from the
page's own frame header, on the host, so it adapts to what the writer
chose page by page; every other page keeps its NumPy decode
(``pages.decode_page``, then ``apply_dv``). Either way the values are bit
for bit NumPy's.

The device work of one ``decode_group`` call (``DeviceDecode.launch``),
where a page of it took the device route or it has a BF16 or affine
column (the dequant kernel's):

  * one page-locked buffer holds the unpack staging: page descriptors,
    packed streams, dictionaries, deleted rows, and the host-route parts
    of the dequant kernel's columns as pages of their codes' own width
    (a value's bytes are its ``8 * size``-bit code); then the dequant
    kernel's descriptors (``kernels.dequant.staging.layout_columns``);
    one copy takes it to the card;
  * one unpack launch writes every page of the dequant kernel's columns
    into that kernel's staging on the card, so their codes never come
    back, and the device-route pages of the other columns into a region
    after it;
  * the dequant kernel's one launch follows at once on that staging
    (``kernels.dequant.dequant_packed``), while the codes are in L2, into
    the region after the other columns';
  * one copy brings both regions back, then one synchronisation; the
    other columns' host-route pages fill their places there.

``DeviceDecode.dequantize`` hands out the dequant kernel's values. On
``"cpu"`` the buffers are host tensors and both kernels' plain versions
run.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np
import torch

from ..core.encodings.base import BY_NAME, code_dtype, decode_blob, unframe
from ..core.encodings.numeric import _split2
from ..kernels.page_unpack import (Page, layout_pages, page_unpack,
                                   staging_bytes, write_pages)

FIXED_BIT_WIDTH = BY_NAME["fixed_bit_width"].eid
DICTIONARY = BY_NAME["dictionary"].eid
_BASE = 256                 # alignment of the regions of a call's buffer


@dataclasses.dataclass
class Column:
    """One column of a ``decode_group`` call: its parts in page order (host
    decodes, and the ``Page``s the device route decodes), the dtype it is
    read as, and, for a column of the dequant kernel, its ``(scale,
    zero)``."""

    name: str
    dtype: np.dtype
    params: Optional[tuple[float, float]] = None
    parts: list = dataclasses.field(default_factory=list)
    value: Optional[np.ndarray] = None    # assembled by the launch

    @property
    def rows(self) -> int:
        return sum(p.rows if isinstance(p, Page) else len(p)
                   for p in self.parts)

    def codes(self, part) -> np.ndarray:
        """A host part as this column is staged: the dequant kernel's
        codes (bf16 bits, or the affine storage dtype), or as decoded."""
        a = np.asarray(part)
        if self.params is None:
            return a
        if self.dtype == np.uint16:
            return a.view(np.uint16)
        return a.astype(self.dtype, copy=False)


def route_page(blob, page_rows: int, dtype: np.dtype,
               dv: Optional[np.ndarray] = None,
               align: bool = False) -> Optional[Page]:
    """The device route's ``Page`` for a SCALAR page, or None where the
    page keeps its host decode: another top-level encoding, values of
    another dtype than its column is read as, or a header whose decode
    NumPy would refuse. ``dv`` is the deletion vector the gather applies
    (``apply_dv``; None: every row). A compact-deleted page (fewer rows
    than ``page_rows``: an earlier delete removed them) is read as it is
    stored, and keeps its host decode where ``align`` asks for it padded
    back to the raw row space (``_pad_raw``)."""
    eid, header, payload, _ = unframe(blob)
    entries = None
    if eid == FIXED_BIT_WIDTH:
        code, n, width = struct.unpack_from("<BQB", header)
        packed = payload
        if code_dtype(code).kind not in "iu":
            return None
    elif eid == DICTIONARY:
        code, n, nuniq, width = struct.unpack_from("<BQQB", header)
        vblob, packed = _split2(payload)
        if not 0 < nuniq < 2**31 or width >= 64:
            return None
        entries = decode_blob(vblob)
        if len(entries) != nuniq:
            return None
        entries = entries.astype(code_dtype(code), copy=False)
    else:
        return None
    if code_dtype(code) != dtype or width > 64 \
            or len(packed) < (n * width + 7) // 8:
        return None
    n_deleted = 0 if dv is None else int(np.count_nonzero(dv))
    deleted = None
    if n != page_rows:
        if n > page_rows or align or dv is not None \
                and n != page_rows - n_deleted:
            return None
        n_deleted = 0       # the rows were removed from the page itself
    elif n_deleted:
        deleted = np.flatnonzero(dv)
    return Page(packed, width, n - n_deleted, dtype.itemsize, entries,
                deleted)


def _align(n: int, to: int = _BASE) -> int:
    return -(-n // to) * to


def _place(parts: list, itemsize: int, base: int) -> None:
    """Aim each ``Page`` of ``parts`` (a column's, in page order) at its
    rows in a region at byte ``base`` that holds the whole column."""
    at = 0
    for p in parts:
        if isinstance(p, Page):
            p.out_offset = base + at * itemsize
            at += p.rows
        else:
            at += len(p)


def _fill(col: Column, region: np.ndarray) -> None:
    """Write the host-route parts of ``col`` into ``region`` (bytes of the
    whole column, its device-route parts there already)."""
    view, at = region.view(col.dtype), 0
    for p in col.parts:
        if isinstance(p, Page):
            at += p.rows
        else:
            view[at:at + len(p)] = p
            at += len(p)


def _code_pages(col: Column) -> list[Page]:
    """Every part of a dequant kernel's column as a ``Page``: a host-route
    part becomes a page of its codes' bytes, ``8 * size`` bits a value, so
    the unpack copies it into the kernel's staging on the card."""
    out = []
    for p in col.parts:
        if not isinstance(p, Page):
            if not len(p):
                continue
            codes = np.ascontiguousarray(col.codes(p))
            p = Page(codes.view(np.uint8), 8 * codes.itemsize, len(codes),
                     codes.itemsize)
        out.append(p)
    return out


class DeviceDecode:
    """The device route of one ``decode_group`` call on ``device``."""

    def __init__(self, device):
        self.device = device
        self.taken = 0        # pages the route took
        self._values = []     # the dequant kernel's output, a column each

    def take(self, blob, page_rows: int, dtype: np.dtype,
             dv: Optional[np.ndarray] = None,
             align: bool = False) -> Optional[Page]:
        page = route_page(blob, page_rows, dtype, dv, align)
        if page is not None:
            self.taken += 1
        return page

    def launch(self, columns: list[Column]) -> None:
        """Decode every ``Page`` of ``columns`` on the device (one unpack
        launch), the dequant kernel's columns into its staging there, and
        launch that kernel on it at once, while the unpack's codes are in
        L2 (their pages go last in the launch); set ``value`` of each other
        column that has a ``Page``. Every host part is final (its deletion
        vector applied) when this runs. Nothing runs on the device where
        the call has no ``Page`` and no dequant column."""
        dq_cols = [col for col in columns if col.params is not None]
        returned = [col for col in columns if col.params is None
                    and any(isinstance(p, Page) for p in col.parts)]
        if not dq_cols and not returned:
            return
        from .. import resolve_device
        from ..kernels.dequant import dequant_packed, layout_columns
        dev = resolve_device(self.device)
        cuda = dev.type == "cuda"
        dq_parts = [_code_pages(col) for col in dq_cols]
        pages = [p for col in returned for p in col.parts
                 if isinstance(p, Page)] + [p for ps in dq_parts for p in ps]
        dq = layout_columns([(col.rows, col.dtype) for col in dq_cols],
                            [col.params for col in dq_cols])
        q0 = _align(staging_bytes(pages))
        for col, parts, off in zip(dq_cols, dq_parts, dq.code_offsets):
            _place(parts, col.dtype.itemsize, q0 + off)
        v0 = end = _align(q0 + dq.nbytes)
        regions = []
        for col in returned:
            _place(col.parts, col.dtype.itemsize, end)
            regions.append(end - v0)
            end = _align(end + col.rows * col.dtype.itemsize)
        f0, end = end, end + 4 * dq.n_out
        layout = layout_pages(pages)
        staged = q0 + dq.desc.nbytes
        if cuda:
            host = torch.empty(staged, dtype=torch.uint8, pin_memory=True)
            buf = torch.empty(end, dtype=torch.uint8, device=dev)
        else:
            buf = host = torch.empty(end, dtype=torch.uint8)
        h = host.numpy()
        write_pages(h, layout, pages)
        h[q0:staged] = dq.desc.view(np.uint8)
        if cuda:
            buf[:staged].copy_(host[:staged], non_blocking=True)
        page_unpack(buf[:layout.nbytes], layout, buf)
        if dq_cols:
            dequant_packed(buf[q0:q0 + dq.nbytes], dq.n_cols, dq.n_tiles,
                           dq.n_out, out=buf[f0:end].view(torch.float32))
        back = buf[v0:end]
        if cuda:
            back = torch.empty(end - v0, dtype=torch.uint8, pin_memory=True)
            back.copy_(buf[v0:end], non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
        b = back.numpy()
        for col, at in zip(returned, regions):
            region = b[at:at + col.rows * col.dtype.itemsize]
            _fill(col, region)
            col.value = region.view(col.dtype)
        values = b[f0 - v0:].view(np.float32)
        self._values = [values[o:o + r]
                        for o, r in zip(dq.out_offsets, dq.rows)]

    def dequantize(self) -> list[np.ndarray]:
        """The dequant kernel's columns of the call, in the order
        ``launch`` saw them, as float32 host arrays: views of the one
        buffer ``launch`` brought back, which nothing reuses while they
        live."""
        return self._values
