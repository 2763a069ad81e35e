"""Bullion read path.

Feature projection (paper §2.3): footer pread -> binary map scan for column
indices -> byte ranges from the offsets arrays -> targeted preads.  Adjacent
page ranges are coalesced into single I/O operations (the Alpha-style
optimization the paper cites) because ML projections read many columns of the
same row group.

``BullionReader`` owns the file handle, the zero-copy footer view, and the
coalesced-pread primitive (``_read_pages``). Everything above that — decode,
deletion masking, dequantization, predicate filtering — lives in the unified
lazy ``Dataset`` pipeline (``repro_torch.dataset``); the ``project``/
``read_column``/``find_rows`` methods below are deprecated shims that build
the equivalent one-file plans.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from . import backend as _backend
from . import integrity as _integrity
from .footer import ColKind, Sec, read_footer
from .quantization import QuantSpec

COALESCE_GAP = 64 * 1024  # merge preads when the hole is smaller than this


def default_coalesce_gap(remote: bool = False) -> int:
    """Coalescing gap in bytes: ``BULLION_COALESCE_GAP`` overrides the
    built-in defaults fleet-wide — 64 KiB for local files, 1 MiB for
    object-store shards, where hole bytes are cheap next to per-request
    latency. 0 still merges physically contiguous ranges (two preads for
    one contiguous span is never right) but bridges no holes, so
    ``wasted_bytes`` stays 0."""
    env = os.environ.get("BULLION_COALESCE_GAP")
    if env is None or not env.strip():
        return _backend.REMOTE_COALESCE_GAP if remote else COALESCE_GAP
    try:
        gap = int(env)
    except ValueError:
        raise ValueError(
            f"BULLION_COALESCE_GAP must be an integer byte count, "
            f"got {env!r}") from None
    if gap < 0:
        raise ValueError(f"BULLION_COALESCE_GAP must be >= 0, got {gap}")
    return gap


@dataclass
class IOStats:
    preads: int = 0
    bytes_read: int = 0
    footer_bytes: int = 0
    metadata_seconds: float = 0.0
    bytes_pruned: int = 0     # data bytes a plan proved it never had to read
                              # (zone maps, row location, head limits)
    pages_pruned: int = 0     # page reads those proofs avoided (group- and
                              # page-granular zone maps)
    coalesced_preads: int = 0  # page reads merged into a larger neighbor
                               # (= preads avoided by range coalescing)
    wasted_bytes: int = 0     # hole bytes read only because coalescing
                              # bridged a gap between two wanted ranges
    footer_cache_hits: int = 0  # shard opens served from the process-wide
                                # footer cache (no footer pread, no parse)
    groups_pruned_sketch: int = 0  # row groups the zone maps admitted but a
                                   # bloom value sketch refuted (point probes
                                   # on unclustered columns)
    backend_fetches: int = 0  # ranged GETs a storage backend served (remote
                              # shards; local reads stay in ``preads``)
    backend_retries: int = 0  # backend requests retried after a 5xx,
                              # timeout, or truncated body
    backend_wasted_bytes: int = 0  # hole bytes fetched remotely because run
                                   # coalescing bridged a gap (the remote
                                   # twin of ``wasted_bytes``)
    pages_verified: int = 0   # page payloads hashed against PAGE_CHECKSUM
                              # before decode (BULLION_VERIFY policy)
    checksum_failures: int = 0  # verification mismatches observed (includes
                                # ones the single re-read recovered)
    pages_quarantined: int = 0  # pages whose mismatch persisted across the
                                # re-read and entered the QuarantineRegistry
    degraded_rows: int = 0    # rows dropped (skip) or zero-masked (mask)
                              # because their page is quarantined

    # -- aggregation (the one field-complete merge every consumer uses) -------
    def merge(self, other: "IOStats") -> "IOStats":
        """Field-wise in-place add. Defined on the dataclass itself so a new
        counter field can never silently drop out of cross-reader
        aggregation (``DataSource.stats``, benchmark CSVs, the metrics
        registry all go through here)."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))
        return self

    @staticmethod
    def sum(items: Iterable["IOStats"]) -> "IOStats":
        total = IOStats()
        for st in items:
            total.merge(st)
        return total

    def delta(self, before: "IOStats") -> "IOStats":
        """Field-wise ``self - before``: what one execution added to a
        cumulative snapshot (``explain(analyze=True)`` reconciliation)."""
        out = IOStats()
        for f in dataclasses.fields(self):
            setattr(out, f.name, getattr(self, f.name) - getattr(before, f.name))
        return out


class BullionReader:
    def __init__(self, path: str, *, footer=None, charge_footer: bool = True,
                 coalesce_gap: Optional[int] = None):
        self.path = path
        t0 = time.perf_counter()
        # the storage backend owns *where* bytes come from: a local fd
        # (byte-identical to the pre-backend read path) or bullion://
        # ranged GETs — everything above this handle is backend-agnostic
        self._handle = _backend.open_shard(path)
        self._remote = self._handle.is_remote
        if footer is None:
            if self._remote:
                self.footer, self.footer_offset = \
                    _backend.read_shard_footer(self._handle)
            else:
                self.footer, self.footer_offset = read_footer(path)
        else:
            # pre-parsed (FooterView, offset) from dataset discovery — the
            # metadata was read exactly once, by the DataSource
            self.footer, self.footer_offset = footer
        if coalesce_gap is None:
            self.coalesce_gap = default_coalesce_gap(remote=self._remote)
        else:
            self.coalesce_gap = int(coalesce_gap)
            if self.coalesce_gap < 0:
                raise ValueError(
                    f"coalesce_gap must be >= 0, got {coalesce_gap}")
        # ``charge_footer=False`` means the footer reads happened elsewhere
        # (or not at all: a footer-cache hit) and must not be double-counted.
        # Local metadata costs two preads (tail, then footer); remote
        # metadata is one speculative tail GET.
        flen = len(self.footer._buf)
        if not charge_footer:
            self.stats = IOStats()
        elif self._remote:
            self.stats = IOStats(backend_fetches=1, footer_bytes=flen,
                                 bytes_read=flen)
        else:
            self.stats = IOStats(preads=2, footer_bytes=flen,
                                 bytes_read=flen)
        self.stats.metadata_seconds = time.perf_counter() - t0
        self._scanner = None
        self._stats_lock = threading.Lock()
        # backend-level charges (remote fetches/retries/bytes) land on the
        # same IOStats every other read path uses
        self._handle.bind_stats(self.stats, self._stats_lock)

    def close(self) -> None:
        """Idempotent: safe to call repeatedly (context-manager exits after
        an aborted plan may race explicit close() calls)."""
        if self._handle is not None:
            self._handle.close()
            self._handle = None

    @property
    def closed(self) -> bool:
        return self._handle is None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- metadata ---------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self.footer.num_rows

    @property
    def column_names(self) -> list[str]:
        return self.footer.column_names()

    def quant_spec(self, col: int) -> QuantSpec:
        from .quantization import QUANT_DTYPE
        recs = self.footer.arr(Sec.QUANT_META, QUANT_DTYPE)
        return QuantSpec.from_record(recs[col])

    @property
    def scanner(self):
        """Statistics-driven pruning scanner (lazy; see repro_torch.scan)."""
        if self._scanner is None:
            from ..scan.scanner import Scanner
            self._scanner = Scanner(self)
        return self._scanner

    def _dataset(self, device=None):
        """One-file lazy Dataset over this (still caller-owned) reader;
        ``device`` is where its range filter runs (default ``cuda``)."""
        from ..dataset.core import Dataset
        return Dataset.from_reader(self, device)

    # -- I/O ----------------------------------------------------------------------
    def _pread(self, offset: int, size: int) -> bytes:
        """Positional read: ``os.pread`` (and its remote twin, one ranged
        GET) never moves a shared cursor, so concurrent ScanTasks on the
        same shard (parallel execution) are safe on one handle. Stats
        mutate under a lock for the same reason. Per-call latency lands in
        the ``bullion.io.pread_seconds`` histogram only while tracing is
        enabled (two extra clock reads are not free on the disabled hot
        path); remote handles charge ``backend_fetches``/``bytes_read``
        themselves."""
        h = self._handle
        if h is None:
            raise ValueError(f"{self.path}: reader is closed")
        if h.is_remote:
            return h.pread(offset, size)
        if _trace.enabled():
            t0 = time.perf_counter()
            data = h.pread(offset, size)
            _metrics.histogram("bullion.io.pread_seconds").observe(
                time.perf_counter() - t0)
        else:
            data = h.pread(offset, size)
        with self._stats_lock:
            self.stats.preads += 1
            self.stats.bytes_read += size
        return data

    def _charge_run(self, off: int, end: int,
                    extents: Sequence[tuple[int, int, int]]) -> None:
        """Coalescing accounting for one run: the reads the merge avoided,
        and the hole bytes it fetched to bridge gaps — charged to
        ``wasted_bytes`` locally, ``backend_wasted_bytes`` remotely (the
        tuning knobs differ, so the counters must too)."""
        covered = sum(s for _, s, _ in extents)
        with self._stats_lock:
            self.stats.coalesced_preads += len(extents) - 1
            if self._remote:
                self.stats.backend_wasted_bytes += (end - off) - covered
            else:
                self.stats.wasted_bytes += (end - off) - covered

    def _pread_run(self, off: int, end: int,
                   extents: Sequence[tuple[int, int, int]]) -> dict[int, bytes]:
        """One positional read covering ``[off, end)``, sliced back into the
        page extents ``(page_off, size, page_id)`` it coalesced. Accounts the
        preads the merge avoided and the hole bytes it read to bridge gaps;
        every coalesced submission's size feeds ``bullion.io.run_bytes``
        (once per run — cheap enough to stay on)."""
        _metrics.histogram("bullion.io.run_bytes").observe(end - off)
        buf = self._pread(off, end - off)
        self._charge_run(off, end, extents)
        return {p: buf[o - off: o - off + s] for o, s, p in extents}

    def _fetch_runs(self, runs, *, max_in_flight: int = 1, span_meta=None):
        """Fetch a batch of coalesced runs ``[(off, end, extents)]``,
        yielding ``(index, {page: bytes} | None, error | None)``.

        Local shards fetch serially in submission order — exactly the one
        ``_pread_run`` per run the scheduler always issued, byte-identical.
        Remote shards hand the whole batch to the async range fetcher,
        which overlaps up to ``max_in_flight`` ranged GETs over keep-alive
        connections and yields in whatever order the object store answers,
        so decode overlaps the slowest range instead of waiting on it.
        Per-run errors are yielded rather than raised: one failed range
        fails only the tasks it covers."""
        meta = span_meta or [{} for _ in runs]
        if not (self._remote and len(runs) > 1 and max_in_flight > 1):
            for i, (off, end, extents) in enumerate(runs):
                sp = _trace.span("io.run", cat="io", bytes=end - off,
                                 extents=len(extents), **meta[i])
                try:
                    with sp:
                        pages = self._pread_run(off, end, extents)
                except Exception as e:
                    yield i, None, e
                else:
                    yield i, pages, None
            return
        sp = _trace.span(
            "io.run_batch", cat="io", runs=len(runs),
            bytes=sum(end - off for off, end, _ in runs),
            max_in_flight=max_in_flight, **meta[0])
        with sp:
            ranges = [(off, end) for off, end, _ in runs]
            for i, body, err in self._handle.fetch_ranges(
                    ranges, max_in_flight=max_in_flight):
                if err is not None:
                    yield i, None, err
                    continue
                off, end, extents = runs[i]
                _metrics.histogram("bullion.io.run_bytes").observe(end - off)
                self._charge_run(off, end, extents)
                yield i, {p: body[o - off: o - off + s]
                          for o, s, p in extents}, None

    def _read_pages(self, page_ids: Sequence[int]) -> dict[int, bytes]:
        """Coalesced ranged reads for a set of pages (gap-bridged merging up
        to ``self.coalesce_gap`` hole bytes between wanted ranges)."""
        fv = self.footer
        extents = sorted((fv.page_extent(p), p) for p in page_ids)
        out: dict[int, bytes] = {}
        i = 0
        while i < len(extents):
            (off, size), _ = extents[i]
            j = i + 1
            end = off + size
            while j < len(extents):
                (o2, s2), _ = extents[j]
                if o2 - end > self.coalesce_gap:
                    break
                end = max(end, o2 + s2)
                j += 1
            out.update(self._pread_run(
                off, end, [(o, s, p) for (o, s), p in extents[i:j]]))
            i = j
        # decode-time integrity gate: checksum every materialized page per
        # the BULLION_VERIFY policy before anything decodes it
        return _integrity.verify_pages(self, out)

    # -- projection (deprecated shims over the Dataset plan path) ----------------
    def project(self, names: Sequence[str], groups: Optional[Sequence[int]] = None,
                drop_deleted: bool = True, dequant: bool = True,
                predicate=None, device=None) -> Iterator[dict]:
        """Deprecated: use ``repro_torch.dataset``. Yields one dict per row group
        with decoded columns, via the equivalent one-file plan.

        With ``predicate`` (a ``repro_torch.scan`` Predicate), row groups the zone
        maps prove empty are skipped without any data pread and the yielded
        tables contain only the matching rows (one dict per surviving group
        with >= 1 match)."""
        ds = self._dataset(device).select(list(names)) \
            .drop_deleted(drop_deleted).dequantized(dequant) \
            ._with_groups(groups)
        if predicate is not None:
            ds = ds.where(predicate)
        return ds.to_batches()

    def read_column(self, name: str, **kw) -> np.ndarray | list:
        """Deprecated: use ``repro_torch.dataset``."""
        parts = [t[name] for t in self.project([name], **kw)]
        if isinstance(parts[0], np.ndarray):
            return np.concatenate(parts)
        return [r for p in parts for r in p]

    # -- helpers for deletion / benchmarks ----------------------------------------
    def locate_rows(self, global_rows: np.ndarray) -> list[tuple[int, np.ndarray]]:
        """Map global row ids -> [(group, local_rows)]."""
        from ..dataset.plan import locate_rows
        return list(locate_rows(self.footer, global_rows).items())

    def find_rows(self, column: str, values, device=None) -> np.ndarray:
        """Deprecated: use ``repro_torch.dataset``. Global row ids (raw row space)
        where column ∈ values.

        On files with zone maps (format v1+) only the row groups whose
        statistics admit one of the values are read; v0 files fall back to
        the full-column scan. String columns keep the legacy full-decode
        membership probe (predicates cover scalar columns only)."""
        from ..scan.predicate import In
        kinds = self.footer.arr(Sec.COL_KIND, np.uint8)
        if kinds[self.footer.column_index(column)] not in \
                (int(ColKind.SCALAR), int(ColKind.MEDIA_REF)):
            data = self.read_column(column, drop_deleted=False, dequant=False,
                                    device=device)
            return np.flatnonzero(np.isin(np.asarray(data), np.asarray(values)))
        return self._dataset(device).where(In(column, values)) \
            .drop_deleted(False).row_ids()
