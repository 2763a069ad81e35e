"""Dataset sources: shard discovery, schema checking, reader lifecycle.

A ``DataSource`` owns the ordered list of Bullion shards behind a dataset —
one file, a directory of shards, a glob, or an explicit path list — plus the
per-shard ``BullionReader`` handles. Shards are discovered and
schema-checked at open time: every shard must agree with shard 0 on column
names, kinds, and logical dtypes, so one plan executes unchanged over all
of them. Global row ids are raw per-shard row ids offset by the cumulative
row counts of the preceding shards (shard order = discovery order).

Footer metadata is served from a process-wide cache (``cached_footer``):
repeated ``dataset()`` opens, the training loader's per-rank construction,
and ``write_to``'s read side all share one parsed ``FooterView`` per
unchanged shard, validated by (mtime, size, inode) and counted in
``IOStats.footer_cache_hits``. Shards may also live in object storage:
``bullion://bucket/key`` URIs route through ``repro_torch.core.backend`` and
their footer-cache entries validate by (ETag, length) instead of the stat
triple.
"""

from __future__ import annotations

import glob as _glob
import os
import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence, Union

import numpy as np

from ..core import backend as _backend
from ..core.footer import (MAGIC, FooterView, Sec, ShardCorruptError,
                           register_footer_invalidator, read_footer)
from ..core.reader import BullionReader, IOStats, default_coalesce_gap
from ..obs import metrics as _metrics

PathSpec = Union[str, Sequence[str]]


class SchemaMismatchError(ValueError):
    """A shard disagrees with the dataset schema (names/kinds/dtypes)."""


# ---------------------------------------------------------------------------
# process-wide footer cache
# ---------------------------------------------------------------------------
#
# Every ``dataset()`` open, loader construction, and ``write_to`` read side
# used to re-pread and re-parse each shard's footer. Footers are immutable
# for an unchanged file, so one parse per (path, file version) is enough for
# the whole process: the cache maps absolute path -> parsed ``FooterView``,
# validated by (mtime_ns, size, inode) on every lookup so a rewritten shard
# invalidates itself. In-process rewriters (``BullionWriter.close``,
# ``deletion.delete_rows``) also drop their entry explicitly, which protects
# same-size rewrites on filesystems with coarse timestamp granularity.

_FOOTER_CACHE_CAP = 4096
_footer_cache: "OrderedDict[str, tuple[tuple, FooterView, int]]" = \
    OrderedDict()
_footer_cache_lock = threading.Lock()


def _footer_validator(path: str) -> tuple:
    st = os.stat(path)
    return (st.st_mtime_ns, st.st_size, st.st_ino)


def cached_footer(path: str) -> tuple[FooterView, int, bool]:
    """Parsed footer for ``path``: ``(view, footer_offset, cache_hit)``.

    A hit costs one ``stat`` and zero preads; a miss reads and parses the
    footer, then caches it keyed by the file's identity+version so every
    later open of the unchanged file is free. ``FooterView`` is read-only
    and safe to share across datasets and threads.

    ``bullion://`` shards have no ``(mtime, size, inode)`` to validate by:
    their cache entries are keyed by URI and validated by the object's
    ``(ETag, length)`` from one HEAD request — a hit costs one HEAD and
    zero range GETs."""
    if _backend.is_remote(path):
        return _cached_footer_remote(path)
    key = os.path.abspath(path)
    val = _footer_validator(path)
    with _footer_cache_lock:
        ent = _footer_cache.get(key)
        if ent is not None and ent[0] == val:
            _footer_cache.move_to_end(key)
            return ent[1], ent[2], True
    try:
        fv, off = read_footer(path)
    except ShardCorruptError:
        # a shard that fails footer/tail validation must not linger in the
        # cache under a stale validator: the repaired/replaced file re-reads
        # fresh on the next open, no process restart needed
        invalidate_cached_footer(path)
        raise
    # only cache if the file didn't change underneath the read (a torn
    # racing rewrite must not be pinned under the pre-rewrite validator)
    if _footer_validator(path) == val:
        with _footer_cache_lock:
            _footer_cache[key] = (val, fv, off)
            _footer_cache.move_to_end(key)
            while len(_footer_cache) > _FOOTER_CACHE_CAP:
                _footer_cache.popitem(last=False)
    return fv, off, False


def _cached_footer_remote(uri: str) -> tuple[FooterView, int, bool]:
    with _backend.open_shard(uri) as h:
        val = h.validator()   # one HEAD: (ETag, length)
        with _footer_cache_lock:
            ent = _footer_cache.get(uri)
            if ent is not None and ent[0] == val:
                _footer_cache.move_to_end(uri)
                return ent[1], ent[2], True
        try:
            fv, off = _backend.read_shard_footer(h)
        except ShardCorruptError:
            invalidate_cached_footer(uri)
            raise
        # same torn-rewrite guard as the local path: only cache if the
        # object identity didn't change underneath the read
        if h.validator() == val:
            with _footer_cache_lock:
                _footer_cache[uri] = (val, fv, off)
                _footer_cache.move_to_end(uri)
                while len(_footer_cache) > _FOOTER_CACHE_CAP:
                    _footer_cache.popitem(last=False)
    return fv, off, False


def invalidate_cached_footer(path: str) -> None:
    """Drop one path's cached footer (called by in-process rewriters)."""
    key = path if _backend.is_remote(path) else os.path.abspath(path)
    with _footer_cache_lock:
        _footer_cache.pop(key, None)


def clear_footer_cache() -> None:
    with _footer_cache_lock:
        _footer_cache.clear()


# core-layer rewriters (BullionWriter.close, deletion.delete_rows) notify
# through repro_torch.core.footer so core never imports upward into this layer
register_footer_invalidator(invalidate_cached_footer)


def _is_bullion(path: str) -> bool:
    if path.endswith(".tmp"):
        # an atomic-write staging file: even a *completed* tmp (crash
        # between the final fsync and the rename) must stay invisible to
        # discovery and the sink's clash check
        return False
    try:
        with open(path, "rb") as f:
            f.seek(-8, 2)
            return f.read(8) == MAGIC
    except OSError:
        return False


def discover(spec: PathSpec) -> list[str]:
    """Resolve a path / directory / glob / explicit list into shard paths.
    ``bullion://bucket/key`` URIs pass through to the object-store backend
    (existence and magic are checked at footer-read time, where missing
    keys and unreachable endpoints raise ``FileNotFoundError``); lists may
    mix local paths and URIs."""
    if not isinstance(spec, str):
        paths = [str(p) for p in spec]
        if not paths:
            raise FileNotFoundError("empty dataset path list")
        return paths
    if _backend.is_remote(spec):
        _backend.parse_uri(spec)   # malformed URIs fail here, not mid-scan
        return [spec]
    if os.path.isdir(spec):
        paths = sorted(os.path.join(spec, n) for n in os.listdir(spec)
                       if os.path.isfile(os.path.join(spec, n)))
        paths = [p for p in paths if _is_bullion(p)]
        if not paths:
            raise FileNotFoundError(f"no Bullion shards in directory {spec!r}")
        return paths
    if any(ch in spec for ch in "*?["):
        matched = sorted(_glob.glob(spec))
        if not matched:
            raise FileNotFoundError(f"glob {spec!r} matched no files")
        paths = [p for p in matched if _is_bullion(p)]
        if not paths:
            raise FileNotFoundError(
                f"glob {spec!r} matched no Bullion files "
                f"({len(matched)} non-Bullion match(es) skipped)")
        return paths
    if not os.path.exists(spec):
        raise FileNotFoundError(
            f"dataset path {spec!r} does not exist (expected a Bullion "
            "file, a shard directory, a glob pattern, or a path list)")
    return [spec]


def _schema_sig(fv: FooterView):
    return (tuple(fv.column_names()),
            tuple(fv.arr(Sec.COL_KIND, np.uint8).tolist()),
            tuple(fv.arr(Sec.COL_LOGICAL, np.uint8).tolist()))


class DataSource:
    """Ordered shards + lazy readers + global row-offset map."""

    def __init__(self, paths: Sequence[str], *,
                 readers: Optional[Sequence[BullionReader]] = None,
                 owns_readers: bool = True,
                 coalesce_gap: Optional[int] = None):
        self.paths = list(paths)
        self.owns_readers = owns_readers
        self.coalesce_gap = coalesce_gap   # None = reader default (env var)
        self._readers: list[Optional[BullionReader]] = \
            list(readers) if readers is not None else [None] * len(self.paths)
        # retired accounting folds into the process-wide metrics registry as
        # it lands here (``bullion.io.*`` counters) — the registry is the
        # cross-dataset aggregate; ``stats`` stays the per-dataset view
        self._retired: list[IOStats] = []
        self._open_lock = threading.Lock()   # parallel tasks race reader()
        self._invalid: Optional[str] = None
        # resolve every footer now — schema mismatches surface at dataset()
        # time, not deep inside a scan — but hold no file handles: planning
        # is footer-only, and readers open lazily per shard on first data
        # access (a 10k-shard dataset must not pin 10k descriptors). Footers
        # come from the process-wide cache, so repeated opens of unchanged
        # shards re-pread and re-parse nothing; the parsed views are handed
        # to the lazy readers so metadata is read at most once per shard
        # version across the whole process.
        t0 = time.perf_counter()
        self._foots: list[tuple[FooterView, int]] = []
        self._foot_hits: list[bool] = []
        for r, p in zip(self._readers, self.paths):
            if r is not None:
                self._foots.append((r.footer, r.footer_offset))
                self._foot_hits.append(False)
            else:
                fv, off, hit = cached_footer(p)
                self._foots.append((fv, off))
                self._foot_hits.append(hit)
        hits = sum(self._foot_hits)
        if hits:
            self._retire(IOStats(
                footer_cache_hits=hits,
                metadata_seconds=time.perf_counter() - t0))
        self._footers = [f for f, _ in self._foots]
        self._sig = _schema_sig(self._footers[0])
        self.column_names: list[str] = list(self._sig[0])
        self.column_set = frozenset(self.column_names)
        offsets = [0]
        for i, fv in enumerate(self._footers):
            if i and _schema_sig(fv) != self._sig:
                raise SchemaMismatchError(
                    f"shard {self.paths[i]!r} schema {_schema_sig(fv)[0]} "
                    f"does not match shard {self.paths[0]!r} schema "
                    f"{self._sig[0]} (column names, kinds, and logical "
                    "dtypes must agree across a dataset)")
            offsets.append(offsets[-1] + fv.num_rows)
        self._row_offsets = np.asarray(offsets, np.int64)

    @classmethod
    def from_reader(cls, reader: BullionReader) -> "DataSource":
        """Wrap an already-open reader (legacy shims). Not owned: closing
        the dataset leaves the caller's reader open."""
        return cls([reader.path], readers=[reader], owns_readers=False)

    # -- shards -----------------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.paths)

    def reader(self, shard: int) -> BullionReader:
        """Open (or reuse) the shard's data reader — first data access.
        Reuses the footer parsed at discovery time (no second parse), and is
        the *only* fd per shard: parallel tasks and the I/O scheduler's
        prefetch thread all share it via positional reads. A footer-cache
        hit charges no footer preads (nobody re-read the metadata)."""
        self._check_valid()
        r = self._readers[shard]
        if r is None:
            with self._open_lock:
                r = self._readers[shard]
                if r is None:
                    r = self._readers[shard] = BullionReader(
                        self.paths[shard], footer=self._foots[shard],
                        charge_footer=not self._foot_hits[shard],
                        coalesce_gap=self.coalesce_gap)
        return r

    def footer(self, shard: int) -> FooterView:
        """Footer-only access: never opens a file handle."""
        self._check_valid()
        r = self._readers[shard]
        return r.footer if r is not None else self._footers[shard]

    def shard_coalesce_gap(self, shard: int) -> int:
        """The run-coalescing gap a shard's reader will use, computed
        footer-only (no handle opens): the dataset override when given,
        else the backend default — 64 KiB local, 1 MiB for object-store
        shards, where hole bytes are cheaper than extra ranged GETs."""
        if self.coalesce_gap is not None:
            return int(self.coalesce_gap)
        return default_coalesce_gap(
            remote=_backend.is_remote(self.paths[shard]))

    def invalidate(self, reason: str) -> None:
        """Mark cached footers stale (a rewrite — e.g. ``delete_where`` —
        changed the files underneath). Every later access raises; callers
        reopen with ``dataset()``."""
        self._invalid = reason

    def _check_valid(self) -> None:
        if self._invalid is not None:
            raise ValueError(
                f"dataset is stale: {self._invalid}; reopen with dataset()")

    def row_offset(self, shard: int) -> int:
        return int(self._row_offsets[shard])

    @property
    def num_rows(self) -> int:
        return int(self._row_offsets[-1])

    @property
    def schema_path(self) -> str:
        """The shard whose footer defines the dataset schema (shard 0)."""
        return self.paths[0]

    def credit_pruned(self, nbytes: int, npages: int = 0,
                      sketch_groups: int = 0) -> None:
        """Account plan-proven avoided I/O without opening any reader.
        For a borrowed reader (legacy shims), the credit must land on the
        caller's IOStats — this source is discarded right after the call."""
        if not self.owns_readers:
            self._readers[0].stats.bytes_pruned += int(nbytes)
            self._readers[0].stats.pages_pruned += int(npages)
            self._readers[0].stats.groups_pruned_sketch += int(sketch_groups)
        else:
            self._retire(IOStats(bytes_pruned=int(nbytes),
                                 pages_pruned=int(npages),
                                 groups_pruned_sketch=int(sketch_groups)))

    # -- lifecycle --------------------------------------------------------------
    def _retire(self, st: IOStats) -> None:
        self._retired.append(st)
        _metrics.absorb_iostats(st)

    def close(self) -> None:
        """Close owned readers (idempotent). Their I/O accounting is retired
        into ``stats`` so aggregates survive the handles."""
        if not self.owns_readers:
            return
        for i, r in enumerate(self._readers):
            if r is not None:
                self._retire(r.stats)
                r.close()
                self._readers[i] = None

    @property
    def stats(self) -> IOStats:
        """Aggregate IOStats across live and retired shard readers."""
        return IOStats.sum((*self._retired,
                            *(r.stats for r in self._readers
                              if r is not None)))
