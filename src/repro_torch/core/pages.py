"""Physical page payloads.

A page holds one bounded row range of a column chunk (a chunk is a
contiguous run of pages; see ``BullionWriter(page_rows=)``) in one of four
layouts:
  SCALAR       -> one cascaded-encoding blob
  LIST         -> offsets blob + values blob (ragged list<T>)
  STRING       -> string column blob (offsets + byte data)
  SPARSE_DELTA -> §2.2 sliding-window delta page for list<int64>
"""

from __future__ import annotations

import struct

import numpy as np

from . import sparse_delta
from .encodings import (EncodeContext, decode_blob, decode_strings,
                        encode_array, encode_strings, mask_blob)
from .encodings.numeric import _cat, _split2
from .footer import PageType


def build_scalar_page(arr: np.ndarray, ctx: EncodeContext) -> bytes:
    return encode_array(arr, ctx)


def build_list_page(rows: list[np.ndarray], ctx: EncodeContext,
                    use_sparse_delta: bool = False) -> tuple[bytes, PageType]:
    lens = np.asarray([len(r) for r in rows], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    values = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    blob = _cat(encode_array(offsets, ctx.child()), encode_array(values, ctx.child()))
    plain = struct.pack("<Q", len(rows)) + blob
    if use_sparse_delta:
        # §2.2 sliding-window deltas pay off only when adjacent rows share
        # window content (write-order locality); on reordered/unrelated rows
        # they degenerate, so ship whichever page is smaller — each page
        # records its own type, so the choice is per chunk.
        sd = sparse_delta.encode_page(rows, ctx)
        if len(sd) < len(plain):
            return sd, PageType.SPARSE_DELTA
    return plain, PageType.LIST


def build_string_page(strings: list[bytes], ctx: EncodeContext) -> bytes:
    return encode_strings(strings, ctx)


def decode_scalar_page(payload: bytes | memoryview) -> np.ndarray:
    return decode_blob(payload)


def decode_list_page(payload: bytes | memoryview) -> list[np.ndarray]:
    mv = memoryview(payload)
    (n,) = struct.unpack_from("<Q", mv)
    off_blob, val_blob = _split2(mv[8:])
    offsets = decode_blob(off_blob).astype(np.int64)
    values = decode_blob(val_blob)
    return [values[offsets[i]:offsets[i + 1]] for i in range(n)]


def decode_page(ptype: int, payload: bytes | memoryview):
    ptype = PageType(ptype)
    if ptype == PageType.SCALAR:
        return decode_scalar_page(payload)
    if ptype == PageType.LIST:
        return decode_list_page(payload)
    if ptype == PageType.STRING:
        return decode_strings(payload)
    if ptype == PageType.SPARSE_DELTA:
        return sparse_delta.decode_page(payload)
    if ptype == PageType.MEDIA_REF:
        return decode_scalar_page(payload)
    raise ValueError(ptype)


def apply_dv(decoded, dv: np.ndarray | None, page_rows: int):
    """Merge-on-read: drop deleted rows. Handles compact-deleted scalar pages
    (len < page_rows after an RLE in-place delete)."""
    if dv is None or not dv.any():
        if isinstance(decoded, np.ndarray) and len(decoded) > page_rows:
            return decoded[:page_rows]
        return decoded
    keep = ~dv
    if isinstance(decoded, np.ndarray):
        if len(decoded) == page_rows:
            return decoded[keep]
        # compact-delete already removed them physically
        assert len(decoded) == int(keep.sum()), (len(decoded), page_rows, int(keep.sum()))
        return decoded
    return [r for r, k in zip(decoded, keep) if k]


# ---------------------------------------------------------------------------
# in-place deletion masking (Bullion §2.1, level 2)
# ---------------------------------------------------------------------------


def mask_page(ptype: int, payload: bytes, positions: np.ndarray,
              page_rows: int) -> bytes | None:
    """Physically mask `positions` (indices into the page's *current
    physical* row space — the caller shifts logical indices for compacted
    pages) preserving page size. Returns the same-length payload, or None ->
    caller must fall back (deletion vector / relocation)."""
    ptype = PageType(ptype)
    positions = np.asarray(positions, np.int64)
    if ptype in (PageType.SCALAR, PageType.MEDIA_REF):
        return mask_blob(payload, positions, page_rows)
    if ptype == PageType.LIST:
        rows = decode_list_page(payload)
        for p in positions:
            rows[p] = np.zeros_like(rows[p])  # erase ids, keep shape
        blob, _ = build_list_page(rows, EncodeContext())
        if len(blob) <= len(payload):
            return blob + b"\x00" * (len(payload) - len(blob))
        return None
    if ptype == PageType.STRING:
        strings = decode_strings(payload)
        for p in positions:
            strings[p] = b"\x00" * len(strings[p])
        blob = build_string_page(strings, EncodeContext())
        if len(blob) <= len(payload):
            return blob + b"\x00" * (len(payload) - len(blob))
        return None
    if ptype == PageType.SPARSE_DELTA:
        rows = sparse_delta.decode_page(payload)
        for p in positions:
            rows[p] = np.zeros_like(rows[p])
        blob = sparse_delta.encode_page(rows, EncodeContext())
        if len(blob) <= len(payload):
            return blob + b"\x00" * (len(payload) - len(blob))
        return None
    raise ValueError(ptype)


def rebuild_page(ptype: int, payload: bytes, positions: np.ndarray,
                 compact: bool = False) -> bytes:
    """Unconstrained rebuild with `positions` (physical indices) erased —
    used when in-place masking cannot satisfy the size criterion and the page
    must be relocated (old extent is zeroed by the caller). ``compact=True``
    preserves the compacted-page invariant by removing the rows instead of
    zeroing them."""
    ptype = PageType(ptype)
    positions = np.asarray(positions, np.int64)
    ctx = EncodeContext()
    if ptype in (PageType.SCALAR, PageType.MEDIA_REF):
        arr = decode_scalar_page(payload).copy()
        if compact:
            keep = np.ones(len(arr), bool)
            keep[positions] = False
            arr = arr[keep]
        else:
            arr[positions] = 0
        return build_scalar_page(arr, ctx)
    if ptype == PageType.LIST:
        rows = decode_list_page(payload)
        for p in positions:
            rows[p] = np.zeros_like(rows[p])
        return build_list_page(rows, ctx)[0]
    if ptype == PageType.STRING:
        strings = decode_strings(payload)
        for p in positions:
            strings[p] = b"\x00" * len(strings[p])
        return build_string_page(strings, ctx)
    if ptype == PageType.SPARSE_DELTA:
        rows = sparse_delta.decode_page(payload)
        for p in positions:
            rows[p] = np.zeros_like(rows[p])
        return sparse_delta.encode_page(rows, ctx)
    raise ValueError(ptype)
