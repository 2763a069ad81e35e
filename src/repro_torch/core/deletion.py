"""Deletion compliance (Bullion §2.1).

Three configurable levels:
  L0 — legacy behaviour: compliance requires rewriting whole files.
  L1 — deletion vectors only: query-time filtering, data still on disk
       (fast, but does NOT satisfy timely-physical-erasure regulations).
  L2 — hybrid: deletion vectors *plus* in-place physical masking of the
       affected pages, never exceeding original page size, with incremental
       Merkle checksum maintenance. Only touched pages + the footer are
       rewritten — this is the paper's up-to-50x I/O reduction. When an
       encoding cannot satisfy the size criterion, the page is *relocated*:
       the old extent is zeroed on disk (physical erasure) and a rebuilt page
       is appended before the footer.

Page-state invariant maintained across repeated deletes: a page's decoded
length is either `page_rows` (deleted rows masked to zeros in place) or
`page_rows - popcount(DV)` (compact-deleted, e.g. the paper's RLE rule).
The COMPACTED flag bit in PAGE_FLAGS records which.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from enum import IntEnum

import numpy as np

from . import pages as pages_mod
from .footer import (MAGIC, FooterBuilder, FooterView, PageType, Sec,
                     notify_footer_rewrite, read_footer)
from .merkle import MerkleTree, page_hash

COMPACTED = 0x80  # PAGE_FLAGS high bit
PTYPE_MASK = 0x7F


class Compliance(IntEnum):
    LEVEL0 = 0
    LEVEL1 = 1
    LEVEL2 = 2


@dataclass
class DeleteStats:
    rows_deleted: int = 0
    pages_touched: int = 0
    pages_masked_in_place: int = 0
    pages_relocated: int = 0
    pages_dv_only: int = 0
    bytes_rewritten: int = 0           # pages + footer actually written
    bytes_rewritten_data: int = 0      # page (data) bytes only — the paper's
                                       # "data rewrite I/O" comparison
    bytes_full_rewrite: int = 0        # counterfactual: rewrite whole file (L0)
    hash_ops_incremental: int = 0
    hash_ops_monolithic: int = 0


def _shift(positions: np.ndarray, prior_dv: np.ndarray) -> np.ndarray:
    """Logical -> physical index for compacted pages."""
    return positions - np.cumsum(prior_dv)[positions]


def _erases(ptype: int, before: bytes, after: bytes, positions: np.ndarray,
            phys_rows: int, was_compacted: bool, compact_ok: bool) -> bool:
    """Is an in-place mask result both *physically erasing* and invariant-
    preserving?

    Masking writes 0 — which is no erasure when the stored value was itself
    0, and some encodings cannot even write it (a constant page's mask is a
    no-op, a FOR row at the base keeps decoding the base). An erasure audit
    (``verify_deleted``) would still find the forbidden value in all those
    cases, so the caller must fall back to compact relocation. The compact
    mask rule (rows physically removed) always erases — and is the *only*
    acceptable in-place result for an already-compacted page, whose decoded
    length must keep tracking ``page_rows - popcount(DV)``. That same
    invariant makes it *unacceptable* (``compact_ok=False``) on a
    non-compacted page still holding zero-masked DV rows from earlier
    deletes: compacting only the new rows would leave the decoded length
    tracking neither convention — relocation unions the old rows instead."""
    if ptype not in (int(PageType.SCALAR), int(PageType.MEDIA_REF)):
        return True          # list/string rows are zeroed element-wise
    dec = np.asarray(pages_mod.decode_page(ptype, after))
    if len(dec) == phys_rows - len(positions):
        return compact_ok    # compact rule physically removed the rows
    if was_compacted or len(dec) != phys_rows:
        return False         # compacted pages must stay compacted
    if np.any(dec[positions] != 0):
        return False         # the encoding could not overwrite the value
    orig = np.asarray(pages_mod.decode_page(ptype, before))
    return not np.any(orig[positions] == 0)


def delete_rows(path: str, global_rows: np.ndarray,
                level: Compliance = Compliance.LEVEL2) -> DeleteStats:
    """Delete rows from a Bullion file, per the requested compliance level."""
    from .reader import BullionReader

    stats = DeleteStats(rows_deleted=len(np.asarray(global_rows)))
    if level == Compliance.LEVEL0:
        raise ValueError("LEVEL0 has no in-file delete path: rewrite the file "
                         "(this is the legacy baseline the paper improves on)")

    reader = BullionReader(path)
    fv = reader.footer
    stats.bytes_full_rewrite = os.path.getsize(path)
    n_cols = fv.n_cols
    page_rows = fv.arr(Sec.PAGE_ROWS, np.uint32)
    page_flags = fv.arr(Sec.PAGE_FLAGS, np.uint8).copy()
    page_offset = fv.arr(Sec.PAGE_OFFSET, np.uint64).copy()
    page_size = fv.arr(Sec.PAGE_SIZE, np.uint64).copy()
    n_pages = fv.n_pages
    tree = MerkleTree(fv.arr(Sec.PAGE_CHECKSUM, np.uint64),
                      fv.group_page_start(), fv.n_groups, 1)
    baseline_ops = tree.hash_ops

    dvs: dict[int, np.ndarray] = {}
    touched_stats: set[tuple[int, int, int]] = set()  # (page, group, col)

    def dv_for(p: int) -> np.ndarray:
        if p not in dvs:
            existing = fv.deletion_vector(p)
            dvs[p] = existing if existing is not None \
                else np.zeros(int(page_rows[p]), bool)
        return dvs[p]

    located = reader.locate_rows(global_rows)
    footer_off = reader.footer_offset
    reader.close()

    with open(path, "r+b") as f:
        append_at = footer_off  # relocated pages go where the footer was

        for group, local in located:
            for col in range(n_cols):
                s, e = fv.chunk_pages(group, col)
                row_lo = 0
                for p in range(s, e):
                    # each page covers one row range of the group; only the
                    # pages actually holding victim rows are touched
                    row_hi = row_lo + int(page_rows[p])
                    plocal = local[(local >= row_lo) & (local < row_hi)] \
                        - row_lo
                    row_lo = row_hi
                    if len(plocal) == 0:
                        continue
                    dv = dv_for(p)
                    new_positions = plocal[~dv[plocal]]
                    if len(new_positions) == 0:
                        continue
                    stats.pages_touched += 1
                    if level == Compliance.LEVEL1:
                        stats.pages_dv_only += 1
                        dv[new_positions] = True
                        continue

                    ptype = int(page_flags[p]) & PTYPE_MASK
                    was_compacted = bool(page_flags[p] & COMPACTED)
                    touched_stats.add((p, group, col))
                    off, size = int(page_offset[p]), int(page_size[p])
                    f.seek(off)
                    payload = f.read(size)

                    phys = _shift(new_positions, dv) if was_compacted \
                        else new_positions
                    phys_rows = int(page_rows[p]) - int(dv.sum()) \
                        if was_compacted else int(page_rows[p])
                    masked = pages_mod.mask_page(ptype, payload, phys,
                                                 int(page_rows[p]))
                    if masked is not None and \
                            not _erases(ptype, payload, masked, phys,
                                        phys_rows, was_compacted,
                                        was_compacted or not dv.any()):
                        masked = None
                    if masked is not None:
                        f.seek(off)
                        f.write(masked)
                        stats.bytes_rewritten += size
                        stats.bytes_rewritten_data += size
                        stats.pages_masked_in_place += 1
                        tree.update_page(p, masked)
                        if _compacts(ptype, payload):
                            page_flags[p] |= COMPACTED
                    else:
                        # relocate: zero old extent (physical erasure), append
                        # a rebuilt page before the footer. Scalar pages
                        # relocate *compacted* — rows removed, not zeroed —
                        # so even a stored 0 is audit-proof; previously
                        # zero-masked rows are compacted away with them to
                        # keep the decoded-length invariant.
                        if ptype in (int(PageType.SCALAR),
                                     int(PageType.MEDIA_REF)):
                            if was_compacted:
                                drop = phys
                            else:
                                union = dv.copy()
                                union[new_positions] = True
                                drop = np.flatnonzero(union)
                            rebuilt = pages_mod.rebuild_page(
                                ptype, payload, drop, compact=True)
                            page_flags[p] |= COMPACTED
                        else:
                            rebuilt = pages_mod.rebuild_page(
                                ptype, payload, phys,
                                compact=was_compacted)
                        f.seek(off)
                        f.write(b"\x00" * size)
                        f.seek(append_at)
                        f.write(rebuilt)
                        page_offset[p] = append_at
                        page_size[p] = len(rebuilt)
                        append_at += len(rebuilt)
                        stats.bytes_rewritten += size + len(rebuilt)
                        stats.bytes_rewritten_data += size + len(rebuilt)
                        stats.pages_relocated += 1
                        tree.update_page(p, rebuilt)
                    dv[new_positions] = True

        new_footer = _rebuild_footer(fv, dvs, tree, page_flags, page_offset,
                                     page_size, touched_stats)
        f.seek(append_at)
        f.write(new_footer)
        f.write(struct.pack("<Q", len(new_footer)) + MAGIC)
        f.truncate()
        stats.bytes_rewritten += len(new_footer) + 16

    # the in-place rewrite changed the footer: drop any cached copy even if
    # filesystem timestamps are too coarse to show it
    notify_footer_rewrite(path)

    stats.hash_ops_incremental = tree.hash_ops - baseline_ops
    stats.hash_ops_monolithic = n_pages + fv.n_groups + 1
    return stats


def _compacts(ptype: int, payload: bytes) -> bool:
    """Did mask_page use the compact-delete (RLE) rule on this page?"""
    from .encodings import blob_encoding_name
    return (ptype in (int(PageType.SCALAR), int(PageType.MEDIA_REF))
            and blob_encoding_name(payload) == "rle")


def _rebuild_footer(fv: FooterView, dvs: dict[int, np.ndarray],
                    tree: MerkleTree, page_flags: np.ndarray,
                    page_offset: np.ndarray, page_size: np.ndarray,
                    touched_stats: set[tuple[int, int, int]] = frozenset()) -> bytes:
    fb = FooterBuilder()
    for sid in list(Sec):
        if fv.has(sid):
            fb.put(sid, bytes(fv.raw(sid)))
    meta = fv.meta.copy()
    meta[6] = tree.root
    fb.put(Sec.META, meta)
    fb.put(Sec.PAGE_CHECKSUM, tree.pages)
    fb.put(Sec.GROUP_CHECKSUM, tree.groups)
    fb.put(Sec.PAGE_FLAGS, page_flags)
    fb.put(Sec.PAGE_OFFSET, page_offset)
    fb.put(Sec.PAGE_SIZE, page_size)

    # L2 physical masking writes zeros into touched pages without re-reading
    # survivors, so zone maps are *widened* to include 0 rather than
    # recomputed — pruning stays sound, only slightly less selective.
    if touched_stats and fv.has_stats:
        from ..scan.stats import STAT_DTYPE, widen_to_zero
        pstats = np.frombuffer(bytes(fv.raw(Sec.PAGE_STATS)), STAT_DTYPE).copy()
        cstats = np.frombuffer(bytes(fv.raw(Sec.CHUNK_STATS)), STAT_DTYPE).copy()
        n_cols = fv.n_cols
        for p, g, c in touched_stats:
            widen_to_zero(pstats[p])
            widen_to_zero(cstats[g * n_cols + c])
        fb.put(Sec.PAGE_STATS, pstats)
        fb.put(Sec.CHUNK_STATS, cstats)

    # the same zeros must be admitted by the bloom value sketches: insert
    # 0's key into every touched page/chunk sketch (in-place bit-OR — blob
    # offsets never move), mirroring widen_to_zero above. Relocated pages
    # only *remove* rows, so their old sketch stays a sound superset.
    if touched_stats and fv.has_sketches:
        from ..scan.sketch import BloomSketch, canonical_u64
        data = bytearray(bytes(fv.raw(Sec.SKETCH_DATA)))
        chunk_off = fv.arr(Sec.CHUNK_SKETCH, np.uint64)
        pg_off = fv.arr(Sec.PAGE_SKETCH, np.uint64) \
            if fv.has(Sec.PAGE_SKETCH) else None
        zero = canonical_u64([0.0])
        no_sketch = np.uint64(0xFFFFFFFFFFFFFFFF)
        n_cols = fv.n_cols
        for p, g, c in touched_stats:
            offs = [chunk_off[g * n_cols + c]]
            if pg_off is not None:
                offs.append(pg_off[p])
            for off in offs:
                if off != no_sketch:
                    BloomSketch.from_buffer(data, int(off)).insert(zero)
        fb.put(Sec.SKETCH_DATA, bytes(data))

    n_pages = fv.n_pages
    dv_off = fv.arr(Sec.DV_OFFSET, np.uint64).copy()
    dv_size = fv.arr(Sec.DV_SIZE, np.uint32).copy()
    old_data = bytes(fv.raw(Sec.DV_DATA))
    blobs: list[bytes] = []
    cursor = 0
    new_off = dv_off.copy()
    for p in range(n_pages):
        if p in dvs and dvs[p].any():
            packed = np.packbits(dvs[p].astype(np.uint8), bitorder="little").tobytes()
        elif dv_off[p] != np.uint64(0xFFFFFFFFFFFFFFFF):
            o = int(dv_off[p])
            packed = old_data[o:o + int(dv_size[p])]
        else:
            new_off[p] = np.uint64(0xFFFFFFFFFFFFFFFF)
            dv_size[p] = 0
            continue
        new_off[p] = cursor
        dv_size[p] = len(packed)
        blobs.append(packed)
        cursor += len(packed)
    fb.put(Sec.DV_OFFSET, new_off)
    fb.put(Sec.DV_SIZE, dv_size)
    fb.put(Sec.DV_DATA, b"".join(blobs))
    return fb.build()


def delete_where(path, predicate,
                 level: Compliance = Compliance.LEVEL2, *,
                 device=None) -> DeleteStats:
    """Predicate-based delete: erase every row matching a
    ``repro_torch.scan`` predicate (e.g. ``C("user_id") == victim``).

    ``path`` accepts anything ``dataset()`` opens — one file, a shard
    directory, a glob, or a path list. Victim rows are located through a
    raw-row-space Dataset plan, so on files with zone maps only the row
    groups whose statistics admit a match are read; on multi-shard datasets
    the global row ids are translated to each shard's local raw row space
    and only the affected shards are rewritten (``Dataset.delete_where``).
    ``device`` is where the victims are located: the range filter of a
    float32 range predicate runs there (default ``cuda``; raises where CUDA
    is absent unless given ``"cpu"``)."""
    from ..dataset import dataset

    return dataset(path, device=device).delete_where(predicate, level)


def verify_deleted(path: str, column: str, forbidden_values, *,
                   device=None) -> dict:
    """Compliance audit: scan raw storage for forbidden values.

    Returns counts of (a) rows still *visible* with the value and (b) raw
    occurrences still physically present (L1 leaves them; L2 must not).

    The raw pass audits *physical page content* via the low-level decode —
    below the Dataset row-space API, whose drop_deleted=False mode pads
    compact-deleted rows with 0 to keep raw row ids stable (padding would
    count as a false occurrence when 0 is itself a forbidden value).

    Both passes read stored values (``dequant=False``), so no kernel runs;
    ``device`` is the read path's all the same (default ``cuda``; raises
    where CUDA is absent unless given ``"cpu"``)."""
    from ..dataset.executor import decode_group
    from .reader import BullionReader

    with BullionReader(path) as r:
        visible = r.read_column(column, drop_deleted=True, dequant=False,
                                device=device)
        parts = [decode_group(r, [column], g, drop_deleted=False,
                              dequant=False, device=device)[column]
                 for g in range(r.footer.n_groups)]
        raw = np.concatenate(parts) if isinstance(parts[0], np.ndarray) \
            else [v for p in parts for v in p]
    forbidden = np.asarray(forbidden_values)
    if isinstance(visible, np.ndarray):
        n_vis = int(np.isin(visible, forbidden).sum())
        n_raw = int(np.isin(raw, forbidden).sum())
    else:
        n_vis = sum(bool(np.isin(np.asarray(v), forbidden).any()) for v in visible)
        n_raw = sum(bool(np.isin(np.asarray(v), forbidden).any()) for v in raw)
    return {"visible_rows": n_vis, "raw_occurrences": n_raw}
