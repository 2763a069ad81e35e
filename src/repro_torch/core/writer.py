"""Bullion write path.

Native write-time data organization (paper §2.5): row-wise sorting (e.g.
quality-score descending for multimodal training data) and column-wise layout
reordering (hot features adjacent for coalesced projection reads) are
first-class, UDF-driven hooks — not a query-engine afterthought.

Two buffering modes share one group-flush core:

* **batch** (default) — ``write_table`` only buffers; ``close`` materializes
  the whole table, applies the optional ``sort_udf``, and writes every group.
* **stream** (``stream=True``) — every complete ``rows_per_group`` group is
  encoded and written as soon as it fills, so a sink rewriting a dataset
  holds at most one group per shard in memory. Whole-table ``sort_udf`` is
  incompatible with streaming (sort upstream, e.g. ``Dataset.write_to``'s
  ``sort_by=``).

A column chunk is split into multiple pages of at most ``page_rows`` rows
each (default: an eighth of ``rows_per_group``, floored at 1024 rows — the
production 65536-row group gets 8 pages per column, while tiny groups stay
single-page because per-page encoding overhead would dominate; override per
writer or fleet-wide via the ``BULLION_PAGE_ROWS`` environment variable,
both of which bypass the floor). Every column of a group splits at the
*same* row boundaries, so page ordinal k covers the same row range in every
chunk — that alignment is what lets the scanner prune and the executor
decode at page granularity. ``page_rows >= rows_per_group`` degrades to the
classic one-page-per-chunk layout.

Encoding selection can be steered per page through ``encoding_advisor``: the
zone-map statistics record (min/max/distinct — the LEA feature set) is
computed *before* each page is encoded and handed to the advisor, which may
restrict the cascade's candidate list (see ``encodings.cascade
.advise_candidates``) — smaller, more homogeneous pages give the advisor
strictly better signals than whole-chunk stats. The same records are then
persisted in the footer (``Sec.PAGE_STATS``, merged into
``Sec.CHUNK_STATS``), so stats are collected once and used twice.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Callable, Optional, Sequence

import numpy as np

from ..obs import trace as _trace
from . import pages
from .encodings import EncodeContext
from .encodings.base import dtype_code
from .footer import (ColKind, FooterBuilder, FORMAT_V0, FORMAT_V2,
                     FORMAT_VERSION, MAGIC, PageType, Sec, name_hash,
                     notify_footer_rewrite)
from .merkle import MerkleTree, page_hash
from .quantization import (QUANT_DTYPE, QuantMode, QuantSpec, dequantize,
                           quantize, storage_dtype)


@dataclass
class ColumnSpec:
    name: str
    dtype: str                      # "int64", "float32", "list<int64>", "string", "media_ref"
    quant: QuantSpec = field(default_factory=QuantSpec)
    sparse_delta: bool = False      # §2.2 hint for list<int64> columns

    @property
    def kind(self) -> ColKind:
        if self.dtype.startswith("list<"):
            return ColKind.LIST
        if self.dtype == "string":
            return ColKind.STRING
        if self.dtype == "media_ref":
            return ColKind.MEDIA_REF
        return ColKind.SCALAR

    @property
    def value_dtype(self) -> np.dtype:
        if self.kind == ColKind.LIST:
            return np.dtype(self.dtype[5:-1])
        if self.kind in (ColKind.STRING,):
            return np.dtype(np.uint8)
        if self.kind == ColKind.MEDIA_REF:
            return np.dtype(np.uint64)
        return np.dtype(self.dtype)


# floor for the *derived* page_rows default (rows_per_group / 8): below
# this, per-page encoding overhead outweighs pruning granularity
MIN_DEFAULT_PAGE_ROWS = 1024

SortUDF = Callable[[dict], np.ndarray]         # table -> row permutation
ColumnOrderUDF = Callable[[list[str]], list[str]]  # names -> layout order
# (stats record, n values, storage dtype) -> restricted candidate names
EncodingAdvisor = Callable[[np.ndarray, int, np.dtype],
                           Optional[tuple[str, ...]]]


def _fsync_dir(dirpath: str) -> None:
    """Make a just-completed rename durable. Best-effort: not every
    filesystem or platform supports fsync on a directory fd."""
    try:
        fd = os.open(dirpath or ".", os.O_RDONLY)
    except OSError:  # pragma: no cover - platform-dependent
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - platform-dependent
        pass
    finally:
        os.close(fd)


def quality_sort(column: str, descending: bool = True) -> SortUDF:
    """The paper's quality-aware presorting (§2.5)."""

    def udf(table: dict) -> np.ndarray:
        key = np.asarray(table[column])
        order = np.argsort(-key if descending else key, kind="stable")
        return order

    return udf


class BullionWriter:
    def __init__(self, path: str, schema: Sequence[ColumnSpec],
                 rows_per_group: int = 65536,
                 compliance: int = 2,
                 sort_udf: Optional[SortUDF] = None,
                 column_order_udf: Optional[ColumnOrderUDF] = None,
                 encode_ctx: Optional[EncodeContext] = None,
                 props: Optional[dict[str, str]] = None,
                 collect_stats: bool = True,
                 collect_sketches: Optional[bool] = None,
                 stream: bool = False,
                 encoding_advisor: Optional[EncodingAdvisor] = None,
                 page_rows: Optional[int] = None):
        self.path = path
        self.schema = list(schema)
        self.by_name = {s.name: s for s in self.schema}
        self.rows_per_group = rows_per_group
        if page_rows is None:
            env = os.environ.get("BULLION_PAGE_ROWS")
            if not collect_stats:
                # v0 backward-compat target: seed-shaped single-page chunks
                # (multi-page without page stats prunes nothing anyway); an
                # explicit page_rows= still wins and stamps a stat-less v2
                page_rows = rows_per_group
            elif env:
                page_rows = int(env)
            else:
                # derived default only: a floor keeps tiny groups single-
                # page (each page pays a fixed cascade-selection cost at
                # write time); explicit page_rows= / env are taken verbatim
                page_rows = max(MIN_DEFAULT_PAGE_ROWS, rows_per_group // 8)
        if page_rows <= 0:
            raise ValueError(f"page_rows must be positive, got {page_rows}")
        # page budget: every chunk of a group splits at the same multiples of
        # page_rows, so page ordinals align across columns (page-granular
        # pruning depends on this)
        self.page_rows = min(int(page_rows), rows_per_group)
        self.compliance = compliance
        self.sort_udf = sort_udf
        self.column_order_udf = column_order_udf
        self.ctx = encode_ctx or EncodeContext()
        if compliance >= 2 and encode_ctx is None:
            # §2.1: at the strictest compliance level, prefer encodings with a
            # native in-place masking rule (bit-packed, varint, RLE, dict,
            # FOR) for scalar pages so deletes stay in-place. Children of
            # these encodings are unrestricted (masking happens at the top).
            self.ctx = EncodeContext(candidates=(
                "constant", "rle", "dictionary", "for", "fixed_bit_width",
                "varint", "mainly_constant", "trivial"))
        self.props = props or {}
        # write-time zone-map statistics (scan subsystem). ``collect_stats=
        # False`` writes a v0 (stat-less) file — the backward-compat target.
        self.collect_stats = collect_stats
        # bloom value sketches (v3) for unclustered equality probes; they
        # ride the stats pipeline, so stat-less files are also sketch-less
        self.collect_sketches = (collect_stats if collect_sketches is None
                                 else bool(collect_sketches) and collect_stats)
        self.stream = stream
        self.encoding_advisor = encoding_advisor
        if stream and sort_udf is not None:
            raise ValueError(
                "stream=True flushes groups incrementally and cannot apply a "
                "whole-table sort_udf; sort upstream (Dataset.write_to's "
                "sort_by=) or use stream=False")
        self._buffers: dict[str, list] = {s.name: [] for s in self.schema}
        self._n_rows = 0
        self._buffered = 0
        # incremental file state, shared by both modes: stream flushes groups
        # as they fill, batch flushes everything from close()
        self._logical_idx = {s.name: i for i, s in enumerate(self.schema)}
        self._f = None
        self._layout: Optional[list[str]] = None
        self._page_offset: list[int] = []
        self._page_size: list[int] = []
        self._page_rows: list[int] = []
        self._page_cksum: list[int] = []
        self._page_flags: list[int] = []
        self._rows_per_group_arr: list[int] = []
        self._page_stat_recs: list = []              # physical page order
        self._chunk_stat_recs: dict[tuple[int, int], list] = {}
        # canonical u64 sketch keys per physical page (None = unsketched:
        # list/string column, or sketching disabled)
        self._page_sketch_keys: list = []
        # page index per logical (group, col) chunk; with §2.5 layout
        # reordering a group's pages aren't in logical order.
        self._chunk_ranges: dict[tuple[int, int], tuple[int, int]] = {}
        self._group_page_start: list[int] = [0]   # Merkle group partition
        self._n_groups = 0
        self._result: Optional[dict] = None   # close() is idempotent

    # -- buffering -------------------------------------------------------------
    def write_table(self, table: dict) -> None:
        sizes = set()
        for spec in self.schema:
            data = table[spec.name]
            if spec.kind == ColKind.SCALAR or spec.kind == ColKind.MEDIA_REF:
                data = np.asarray(data)
                sizes.add(len(data))
                self._buffers[spec.name].append(data)
            else:
                sizes.add(len(data))
                self._buffers[spec.name].extend(data)
        if len(sizes) != 1:
            raise ValueError(f"ragged table: row counts {sizes}")
        n = sizes.pop()
        self._n_rows += n
        self._buffered += n
        if self.stream:
            while self._buffered >= self.rows_per_group:
                self._flush_group(self.rows_per_group)

    def _collect(self, name: str):
        spec = self.by_name[name]
        if spec.kind in (ColKind.SCALAR, ColKind.MEDIA_REF):
            return np.concatenate(self._buffers[name]) if self._buffers[name] \
                else np.zeros(0, spec.value_dtype)
        return self._buffers[name]

    def _pop_rows(self, take: int) -> dict:
        """Remove the first ``take`` buffered rows as one table. Consumes
        whole buffered chunks and slices only at the group boundary, so each
        flush costs O(take), not O(rows still buffered)."""
        out: dict = {}
        for s in self.schema:
            buf = self._buffers[s.name]
            if s.kind in (ColKind.SCALAR, ColKind.MEDIA_REF):
                parts, got = [], 0
                while got < take:
                    head = buf[0]
                    need = take - got
                    if len(head) <= need:
                        parts.append(buf.pop(0))
                        got += len(head)
                    else:
                        parts.append(head[:need])
                        buf[0] = head[need:]     # view, no copy
                        got = take
                out[s.name] = parts[0] if len(parts) == 1 else (
                    np.concatenate(parts) if parts
                    else np.zeros(0, s.value_dtype))
            else:
                out[s.name] = buf[:take]
                del buf[:take]
        self._buffered -= take
        return out

    # -- group flushing ----------------------------------------------------------
    def _flush_group(self, take: int) -> None:
        self._write_group(self._pop_rows(take), take)

    def _write_group(self, table: dict, n_rows: int) -> None:
        with _trace.span("write.group", cat="sink", rows=n_rows,
                         group=self._n_groups):
            self._write_group_inner(table, n_rows)

    @property
    def _tmp_path(self) -> str:
        """Crash-safe staging file: all bytes land in ``path + ".tmp"`` and
        only a completed, fsynced shard is renamed over ``path``, so a
        crash at any point leaves either the old file or an ignorable tmp —
        never a torn shard visible to readers (discovery skips ``.tmp``)."""
        return self.path + ".tmp"

    def _write_group_inner(self, table: dict, n_rows: int) -> None:
        if self._f is None:
            self._f = open(self._tmp_path, "wb")
            # §2.5 column layout reordering (hot columns adjacent)
            layout = [s.name for s in self.schema]
            if self.column_order_udf is not None:
                layout = self.column_order_udf(layout)
                assert sorted(layout) == sorted(s.name for s in self.schema)
            self._layout = layout
        g = self._n_groups
        self._rows_per_group_arr.append(n_rows)
        # every column splits at the same page_rows multiples, so ordinal k
        # covers one row range group-wide; a zero-row group still carries one
        # (empty) page per column so readers see well-formed chunks
        bounds = list(range(0, n_rows, self.page_rows)) or [0]
        for name in self._layout:
            spec = self.by_name[name]
            data = table[name]
            start_page = len(self._page_offset)
            for lo in bounds:
                hi = min(lo + self.page_rows, n_rows)
                blob, ptype, rec, skeys = self._build_page(spec, data[lo:hi])
                self._page_offset.append(self._f.tell())
                self._page_size.append(len(blob))
                self._page_rows.append(hi - lo)
                self._page_cksum.append(page_hash(blob))
                self._page_flags.append(int(ptype))
                self._f.write(blob)
                if self.collect_stats:
                    self._page_stat_recs.append(rec)
                    self._chunk_stat_recs.setdefault(
                        (g, self._logical_idx[name]), []).append(rec)
                if self.collect_sketches:
                    self._page_sketch_keys.append(skeys)
            self._chunk_ranges[(g, self._logical_idx[name])] = \
                (start_page, len(self._page_offset))
        self._group_page_start.append(len(self._page_offset))
        self._n_groups += 1

    # -- finalize ----------------------------------------------------------------
    def abort(self) -> None:
        """Drop an unfinished file: close the handle and unlink the staging
        tmp (nothing was ever renamed over ``path``, so readers never saw a
        partial shard). No-op after a successful ``close()``."""
        if self._result is None and self._f is not None:
            self._f.close()
            self._f = None
            try:
                os.unlink(self._tmp_path)
            except OSError:
                pass

    def close(self) -> dict:
        if self._result is not None:
            return self._result            # idempotent: the file is final
        if self.stream:
            while self._buffered >= self.rows_per_group:
                self._flush_group(self.rows_per_group)
            if self._buffered:
                self._flush_group(self._buffered)
        else:
            table = {s.name: self._collect(s.name) for s in self.schema}
            # §2.5 write-path row reordering (quality sort etc.)
            if self.sort_udf is not None and self._n_rows:
                perm = self.sort_udf(table)
                for s in self.schema:
                    data = table[s.name]
                    table[s.name] = data[perm] \
                        if isinstance(data, np.ndarray) \
                        else [data[i] for i in perm]
            self._buffers = {s.name: [] for s in self.schema}
            self._buffered = 0
            for lo in range(0, self._n_rows, self.rows_per_group):
                hi = min(lo + self.rows_per_group, self._n_rows)
                self._write_group({k: v[lo:hi] for k, v in table.items()},
                                  hi - lo)
        if self._n_groups == 0:
            # zero-row file still carries one (empty) group so readers see a
            # well-formed group/page structure
            self._flush_group(0)
        if self._f is None:  # pragma: no cover - _flush_group always opens
            self._f = open(self._tmp_path, "wb")

        n_rows, n_cols = self._n_rows, len(self.schema)
        n_groups, n_pages = self._n_groups, len(self._page_offset)
        f = self._f

        starts = np.zeros(n_groups * n_cols, np.uint64)
        counts = np.zeros(n_groups * n_cols, np.uint32)
        for (g, c), (s, e) in self._chunk_ranges.items():
            starts[g * n_cols + c] = s
            counts[g * n_cols + c] = e - s

        cksums = np.asarray(self._page_cksum, np.uint64)
        # merkle over physical page order, grouped by row group
        group_page_start = np.asarray(self._group_page_start, np.uint64)
        tree = MerkleTree(cksums, group_page_start, n_groups, 1)

        fb = FooterBuilder()
        meta = np.zeros(8, np.uint64)
        meta[0], meta[1], meta[2], meta[3] = n_rows, n_cols, n_groups, n_pages
        meta[4] = self.rows_per_group
        meta[5] = self.compliance
        meta[6] = tree.root
        # version word is informational (readers detect capabilities by
        # section presence), but must not claim v0 — one page per chunk —
        # for a file that actually carries multi-page chunks
        multi_page = any(e - s > 1 for s, e in self._chunk_ranges.values())
        if self.collect_stats:
            meta[7] = FORMAT_VERSION if self.collect_sketches else FORMAT_V2
        else:
            meta[7] = FORMAT_V2 if multi_page else FORMAT_V0
        fb.put(Sec.META, meta)

        if self.collect_stats:
            from ..scan.stats import STAT_DTYPE, merge_records
            page_stats = np.zeros(n_pages, STAT_DTYPE)
            for i, rec in enumerate(self._page_stat_recs):
                page_stats[i] = rec
            chunk_stats = np.zeros(n_groups * n_cols, STAT_DTYPE)
            for (g, c), recs in self._chunk_stat_recs.items():
                chunk_stats[g * n_cols + c] = \
                    recs[0] if len(recs) == 1 else merge_records(recs)
            fb.put(Sec.PAGE_STATS, page_stats)
            fb.put(Sec.CHUNK_STATS, chunk_stats)

        if self.collect_sketches:
            from ..scan.sketch import NO_SKETCH, BloomSketch
            chunk_off = np.full(n_groups * n_cols, NO_SKETCH, np.uint64)
            page_off = np.full(n_pages, NO_SKETCH, np.uint64)
            blobs: list[bytes] = []
            pos = 0
            for (g, c), (s, e) in sorted(self._chunk_ranges.items()):
                parts = [k for k in self._page_sketch_keys[s:e]
                         if k is not None]
                if len(parts) != e - s:
                    continue       # unsketched column (list/string pages)
                keys = parts[0] if len(parts) == 1 else \
                    np.unique(np.concatenate(parts))
                sk = BloomSketch.build(keys)
                if sk is None:
                    continue       # over the size cap: absent = no pruning
                b = sk.to_bytes()
                chunk_off[g * n_cols + c] = pos
                blobs.append(b)
                pos += len(b)
                if e - s > 1:
                    # per-page sketches only pay off when there is more than
                    # one ordinal to choose between (mirrors _page_prune)
                    for p in range(s, e):
                        psk = BloomSketch.build(self._page_sketch_keys[p])
                        if psk is None:
                            continue
                        pb = psk.to_bytes()
                        page_off[p] = pos
                        blobs.append(pb)
                        pos += len(pb)
            fb.put(Sec.CHUNK_SKETCH, chunk_off)
            fb.put(Sec.PAGE_SKETCH, page_off)
            fb.put(Sec.SKETCH_DATA, b"".join(blobs))

        names = [s.name for s in self.schema]
        name_bytes = b"".join(n.encode() for n in names)
        offs = np.zeros(n_cols + 1, np.uint32)
        np.cumsum([len(n.encode()) for n in names], out=offs[1:])
        fb.put(Sec.NAMES_DATA, name_bytes)
        fb.put(Sec.NAMES_OFFSETS, offs)
        hashes = np.asarray([name_hash(n) for n in names], np.uint64)
        order = np.argsort(hashes, kind="stable").astype(np.uint32)
        fb.put(Sec.NAME_HASH_SORTED, hashes[order])
        fb.put(Sec.NAME_HASH_ORDER, order)

        storage_codes, logical_codes, kinds = [], [], []
        quant = np.zeros(n_cols, QUANT_DTYPE)
        for i, s in enumerate(self.schema):
            logical_codes.append(dtype_code(s.value_dtype))
            sd = storage_dtype(s.quant.mode)
            storage_codes.append(dtype_code(sd or s.value_dtype))
            kinds.append(int(s.kind))
            quant[i] = s.quant.to_record()
        fb.put(Sec.COL_DTYPE, np.asarray(storage_codes, np.uint8))
        fb.put(Sec.COL_LOGICAL, np.asarray(logical_codes, np.uint8))
        fb.put(Sec.COL_KIND, np.asarray(kinds, np.uint8))
        fb.put(Sec.QUANT_META, quant)

        fb.put(Sec.ROWS_PER_GROUP,
               np.asarray(self._rows_per_group_arr, np.uint32))
        fb.put(Sec.CHUNK_PAGE_START, starts)
        fb.put(Sec.CHUNK_PAGE_COUNT, counts)
        fb.put(Sec.PAGE_OFFSET, np.asarray(self._page_offset, np.uint64))
        fb.put(Sec.PAGE_SIZE, np.asarray(self._page_size, np.uint64))
        fb.put(Sec.PAGE_ROWS, np.asarray(self._page_rows, np.uint32))
        fb.put(Sec.PAGE_CHECKSUM, cksums)
        fb.put(Sec.PAGE_FLAGS, np.asarray(self._page_flags, np.uint8))
        fb.put(Sec.DV_OFFSET, np.full(n_pages, 0xFFFFFFFFFFFFFFFF, np.uint64))
        fb.put(Sec.DV_SIZE, np.zeros(n_pages, np.uint32))
        fb.put(Sec.DV_DATA, b"")
        fb.put(Sec.GROUP_CHECKSUM, tree.groups)
        # page budget recorded for introspection (write_to keeps the input's
        # page layout by default); user props may override
        props = {"bullion.page_rows": str(self.page_rows), **self.props}
        fb.put(Sec.PROPS, b"\x00".join(
            k.encode() + b"\x00" + v.encode()
            for k, v in props.items()) + b"\x00")

        footer = fb.build()
        f.write(footer)
        f.write(struct.pack("<Q", len(footer)) + MAGIC)
        # crash-safe publication: fsync the staging file, rename it over the
        # final path, then fsync the directory so the rename itself is
        # durable. kill -9 anywhere before the replace leaves only the old
        # file (or nothing) plus an ignorable ``.tmp``.
        f.flush()
        os.fsync(f.fileno())
        f.close()
        self._f = None
        os.replace(self._tmp_path, self.path)
        _fsync_dir(os.path.dirname(os.path.abspath(self.path)))
        # a (re)write at this path obsoletes any cached footer even when
        # filesystem timestamps are too coarse to show it
        notify_footer_rewrite(self.path)

        self._result = {"rows": n_rows, "groups": n_groups, "pages": n_pages,
                        "file_checksum": tree.root}
        return self._result

    # -- write-time statistics ----------------------------------------------------
    def _page_stats_record(self, spec: ColumnSpec, chunk, stored):
        """Zone-map record over the values a reader will decode: quantized
        columns use the already-quantized page array, dequantized back, so
        the recorded range matches ``dequant=True`` reads exactly."""
        from ..scan.stats import stats_record
        if spec.kind == ColKind.SCALAR:
            if spec.quant.mode != QuantMode.NONE:
                return stats_record(np.asarray(dequantize(stored, spec.quant)))
            return stats_record(np.asarray(chunk))
        if spec.kind == ColKind.MEDIA_REF:
            return stats_record(np.asarray(chunk, np.uint64))
        return stats_record(list(chunk))

    def _stats_for(self, spec: ColumnSpec, chunk, stored):
        if not (self.collect_stats or self.encoding_advisor is not None):
            return None
        return self._page_stats_record(spec, chunk, stored)

    def _sketch_keys(self, spec: ColumnSpec, chunk, stored):
        """Canonical u64 keys of one scalar/media_ref page, in the same
        (dequantized) domain the zone maps describe. NaNs are dropped —
        ``== NaN`` matches no row, so omitting them is sound."""
        if not self.collect_sketches or \
                spec.kind not in (ColKind.SCALAR, ColKind.MEDIA_REF):
            return None
        from ..scan.sketch import canonical_u64
        if spec.kind == ColKind.SCALAR and spec.quant.mode != QuantMode.NONE:
            vals = np.asarray(dequantize(stored, spec.quant))
        else:
            vals = np.asarray(chunk)
        if vals.dtype.kind == "f":
            vals = vals[~np.isnan(vals)]
        return np.unique(canonical_u64(vals))

    def _ctx_for(self, rec, arr: np.ndarray) -> EncodeContext:
        """Stats-driven encoding choice hook: the advisor may restrict the
        cascade's candidate list from the chunk's min/max/distinct record.
        A compliance-restricted candidate set (maskable encodings) always
        wins — the advisor can only narrow it further."""
        if self.encoding_advisor is None or rec is None:
            return self.ctx
        advised = self.encoding_advisor(rec, len(arr), arr.dtype)
        if not advised:
            return self.ctx
        if self.ctx.candidates is not None:
            advised = tuple(c for c in advised if c in self.ctx.candidates)
            if not advised:
                return self.ctx
        return _dc_replace(self.ctx, candidates=advised)

    # -- page building -----------------------------------------------------------
    def _build_page(self, spec: ColumnSpec, chunk
                    ) -> tuple[bytes, PageType, object, object]:
        """Returns (payload, page type, stats record or None, sketch keys
        or None)."""
        if spec.kind == ColKind.SCALAR:
            arr = np.asarray(chunk)
            if spec.quant.mode != QuantMode.NONE:
                arr = quantize(arr, spec.quant)
            rec = self._stats_for(spec, chunk, arr)
            blob = pages.build_scalar_page(arr, self._ctx_for(rec, arr))
            return blob, PageType.SCALAR, rec, self._sketch_keys(
                spec, chunk, arr)
        if spec.kind == ColKind.MEDIA_REF:
            arr = np.asarray(chunk, np.uint64)
            rec = self._stats_for(spec, chunk, arr)
            blob = pages.build_scalar_page(arr, self._ctx_for(rec, arr))
            return blob, PageType.MEDIA_REF, rec, self._sketch_keys(
                spec, chunk, arr)
        if spec.kind == ColKind.LIST:
            blob, ptype = pages.build_list_page(
                list(chunk), self.ctx, use_sparse_delta=spec.sparse_delta)
            return blob, ptype, self._stats_for(spec, chunk, None), None
        if spec.kind == ColKind.STRING:
            return pages.build_string_page(list(chunk), self.ctx), \
                PageType.STRING, self._stats_for(spec, chunk, None), None
        raise ValueError(spec.kind)
