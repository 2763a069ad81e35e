"""Bullion compact binary footer (paper §2.3).

The footer is a flat sequence of fixed-dtype sections plus a fixed-size
directory; a reader creates **numpy views directly over the footer bytes with
no deserialization step** (Cap'n-Proto/FlatBuffers style).  Column lookup is a
binary search over a sorted name-hash array — O(log n_cols), independent of
table width, which is what keeps Fig. 5 flat while Parquet-style thrift
metadata grows linearly.

File layout:

    [pages ...][footer][u64 footer_len][8-byte magic]

Footer layout:

    [section payloads ...][directory: n * (u16 sid, u64 off, u64 size)]
    [u32 n_sections]
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

MAGIC = b"BULLION1"
_DIR_ENTRY = struct.Struct("<HQQ")
_TAIL = struct.Struct("<Q8s")


class ShardCorruptError(ValueError):
    """A shard failed structural validation (torn write, bad magic,
    truncated data region) or decode-time checksum verification.

    Subclasses ``ValueError`` so pre-existing ``except (OSError,
    ValueError)`` handlers keep treating corrupt shards as unreadable
    input; new code catches the typed error and reads ``path`` /
    ``reason`` / ``group`` / ``page`` directly."""

    def __init__(self, path: str, reason: str, *,
                 group: int | None = None, page: int | None = None):
        self.path = str(path)
        self.reason = reason
        self.group = group
        self.page = page
        loc = ""
        if group is not None or page is not None:
            loc = f" (group {group}, page {page})"
        super().__init__(f"{self.path}: corrupt shard{loc}: {reason}")

# Format versions (META word 7). Readers never gate on the version number —
# capabilities are detected by section presence (``has``) — so every older
# file remains fully readable: v0 files lack stats sections and never prune,
# v1 files lack the page-count index and read as one page per chunk.
FORMAT_V0 = 0             # seed format: no statistics sections
FORMAT_V1 = 1             # + PAGE_STATS / CHUNK_STATS zone maps
FORMAT_V2 = 2             # + CHUNK_PAGE_COUNT (multi-page chunks)
FORMAT_V3 = 3             # + CHUNK_SKETCH / PAGE_SKETCH bloom value sketches
FORMAT_VERSION = FORMAT_V3


class Sec(IntEnum):
    META = 0              # u64[8]: num_rows, n_cols, n_groups, n_pages, rows_per_group, compliance, file_checksum, format_version
    NAMES_DATA = 1        # raw bytes of all column names
    NAMES_OFFSETS = 2     # u32[n_cols + 1]
    NAME_HASH_SORTED = 3  # u64[n_cols]
    NAME_HASH_ORDER = 4   # u32[n_cols] column index per sorted hash
    COL_DTYPE = 5         # u8[n_cols]  (base.dtype_code of value dtype)
    COL_KIND = 6          # u8[n_cols]  0=scalar 1=list 2=string 3=media_ref
    COL_LOGICAL = 7       # u8[n_cols]  original (pre-quantization) dtype code
    ROWS_PER_GROUP = 8    # u32[n_groups]
    CHUNK_PAGE_START = 9  # u64[n_groups * n_cols] page index per logical chunk
    PAGE_OFFSET = 10      # u64[n_pages]
    PAGE_SIZE = 11        # u64[n_pages]
    PAGE_ROWS = 12        # u32[n_pages]
    PAGE_CHECKSUM = 13    # u64[n_pages]
    PAGE_FLAGS = 14       # u8[n_pages] page payload type
    DV_OFFSET = 15        # u64[n_pages] into DV_DATA (u64max = none)
    DV_SIZE = 16          # u32[n_pages]
    DV_DATA = 17          # bitmap bytes
    GROUP_CHECKSUM = 18   # u64[n_groups]
    QUANT_META = 19       # packed per-column quantization params
    PROPS = 20            # optional key\0value\0... (cold; parsed on demand)
    PAGE_STATS = 21       # STAT_DTYPE[n_pages] zone maps (v1+, see scan.stats)
    CHUNK_STATS = 22      # STAT_DTYPE[n_groups * n_cols] per-chunk zone maps (v1+)
    CHUNK_PAGE_COUNT = 23  # u32[n_groups * n_cols] pages per chunk (v2+; absent = 1)
    CHUNK_SKETCH = 24     # u64[n_groups * n_cols] offset into SKETCH_DATA (v3+; u64max = none)
    PAGE_SKETCH = 25      # u64[n_pages] offset into SKETCH_DATA (v3+; u64max = none)
    SKETCH_DATA = 26      # self-describing bloom blobs (see scan.sketch)


class PageType(IntEnum):
    SCALAR = 0
    LIST = 1
    STRING = 2
    SPARSE_DELTA = 3   # §2.2 long-sequence sliding-window delta page
    MEDIA_REF = 4


class ColKind(IntEnum):
    SCALAR = 0
    LIST = 1
    STRING = 2
    MEDIA_REF = 3


def name_hash(name: str) -> int:
    """FNV-1a 64-bit — cheap, deterministic, no deserialization needed."""
    h = 0xCBF29CE484222325
    for b in name.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclass
class FooterBuilder:
    sections: dict[int, bytes] = field(default_factory=dict)

    def put(self, sid: Sec, data: bytes | np.ndarray) -> None:
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data).tobytes()
        self.sections[int(sid)] = data

    def build(self) -> bytes:
        payloads, directory = [], []
        off = 0
        for sid in sorted(self.sections):
            data = self.sections[sid]
            directory.append(_DIR_ENTRY.pack(sid, off, len(data)))
            payloads.append(data)
            off += len(data)
        return b"".join(payloads) + b"".join(directory) + struct.pack("<I", len(directory))


class FooterView:
    """Zero-deserialization footer access: every section is a numpy view or
    memoryview over the original footer buffer."""

    def __init__(self, buf: bytes | memoryview):
        self._buf = memoryview(buf)
        (n_sections,) = struct.unpack_from("<I", self._buf, len(self._buf) - 4)
        dir_start = len(self._buf) - 4 - n_sections * _DIR_ENTRY.size
        self._dir: dict[int, tuple[int, int]] = {}
        for i in range(n_sections):
            sid, off, size = _DIR_ENTRY.unpack_from(self._buf, dir_start + i * _DIR_ENTRY.size)
            self._dir[sid] = (off, size)

    # -- raw access -----------------------------------------------------------
    def raw(self, sid: Sec) -> memoryview:
        off, size = self._dir[int(sid)]
        return self._buf[off:off + size]

    def arr(self, sid: Sec, dtype) -> np.ndarray:
        return np.frombuffer(self.raw(sid), dtype=dtype)

    def has(self, sid: Sec) -> bool:
        return int(sid) in self._dir

    # -- typed views ----------------------------------------------------------
    @property
    def meta(self) -> np.ndarray:
        return self.arr(Sec.META, np.uint64)

    @property
    def num_rows(self) -> int: return int(self.meta[0])

    @property
    def n_cols(self) -> int: return int(self.meta[1])

    @property
    def n_groups(self) -> int: return int(self.meta[2])

    @property
    def n_pages(self) -> int: return int(self.meta[3])

    @property
    def compliance(self) -> int: return int(self.meta[5])

    @property
    def file_checksum(self) -> int: return int(self.meta[6])

    @property
    def format_version(self) -> int: return int(self.meta[7])

    # -- write-time statistics (v1+; absent on v0 files) ----------------------
    @property
    def has_stats(self) -> bool:
        return self.has(Sec.CHUNK_STATS)

    def page_stats(self) -> np.ndarray | None:
        """STAT_DTYPE[n_pages] view, or None on stat-less (v0) files."""
        if not self.has(Sec.PAGE_STATS):
            return None
        from ..scan.stats import STAT_DTYPE
        return self.arr(Sec.PAGE_STATS, STAT_DTYPE)

    def chunk_stats(self) -> np.ndarray | None:
        """STAT_DTYPE[n_groups * n_cols] view (row-group zone maps), or None."""
        if not self.has(Sec.CHUNK_STATS):
            return None
        from ..scan.stats import STAT_DTYPE
        return self.arr(Sec.CHUNK_STATS, STAT_DTYPE)

    # -- value sketches (v3+; absent on older files) ---------------------------
    @property
    def has_sketches(self) -> bool:
        return self.has(Sec.CHUNK_SKETCH)

    def _sketch_at(self, sid: Sec, idx: int):
        if not self.has(sid):
            return None
        off = self.arr(sid, np.uint64)[idx]
        if off == np.uint64(0xFFFFFFFFFFFFFFFF):
            return None
        from ..scan.sketch import BloomSketch
        return BloomSketch.from_buffer(self.raw(Sec.SKETCH_DATA), int(off))

    def chunk_sketch(self, group: int, col: int):
        """BloomSketch over the chunk's distinct values, or None (no sketch
        section, or this chunk skipped sketching). Absent = prune nothing."""
        return self._sketch_at(Sec.CHUNK_SKETCH, group * self.n_cols + col)

    def page_sketch(self, page: int):
        """BloomSketch over one page's distinct values, or None."""
        return self._sketch_at(Sec.PAGE_SKETCH, page)

    def column_index(self, name: str) -> int:
        """Binary map scan (paper's term): O(log n_cols), no parsing."""
        hashes = self.arr(Sec.NAME_HASH_SORTED, np.uint64)
        order = self.arr(Sec.NAME_HASH_ORDER, np.uint32)
        h = np.uint64(name_hash(name))
        i = int(np.searchsorted(hashes, h))
        offs = self.arr(Sec.NAMES_OFFSETS, np.uint32)
        names_data = self.raw(Sec.NAMES_DATA)
        while i < len(hashes) and hashes[i] == h:  # hash-collision probe
            ci = int(order[i])
            if bytes(names_data[offs[ci]:offs[ci + 1]]).decode() == name:
                return ci
            i += 1
        raise KeyError(name)

    def column_names(self) -> list[str]:
        offs = self.arr(Sec.NAMES_OFFSETS, np.uint32)
        data = self.raw(Sec.NAMES_DATA)
        return [bytes(data[offs[i]:offs[i + 1]]).decode() for i in range(self.n_cols)]

    # -- page addressing -------------------------------------------------------
    def chunk_pages(self, group: int, col: int) -> tuple[int, int]:
        """Return [start, end) page-index range for (row-group, column).
        A chunk holds ``CHUNK_PAGE_COUNT`` consecutive pages (v2+); files
        without the section (v0/v1) are one page per chunk. Layout order may
        differ from logical order (§2.5 column reordering), hence an explicit
        per-chunk index."""
        idx = group * self.n_cols + col
        p = int(self.arr(Sec.CHUNK_PAGE_START, np.uint64)[idx])
        if self.has(Sec.CHUNK_PAGE_COUNT):
            return p, p + int(self.arr(Sec.CHUNK_PAGE_COUNT, np.uint32)[idx])
        return p, p + 1

    def chunk_page_rows(self, group: int, col: int) -> np.ndarray:
        """Per-page row counts of one chunk (u32 view into PAGE_ROWS).
        Pages partition the chunk's rows in order: page k covers group-local
        rows [sum(rows[:k]), sum(rows[:k+1]))."""
        s, e = self.chunk_pages(group, col)
        return self.arr(Sec.PAGE_ROWS, np.uint32)[s:e]

    def group_page_start(self) -> np.ndarray:
        """u64[n_groups + 1] page-index boundary per row group (the Merkle
        tree's group partition). Derived: a group's pages are contiguous, so
        its first page is the min chunk start across its columns; v0/v1
        files degrade to exactly n_cols pages per group."""
        if self.n_groups == 0:
            return np.zeros(1, np.uint64)
        starts = self.arr(Sec.CHUNK_PAGE_START, np.uint64)
        mins = starts.reshape(self.n_groups, self.n_cols).min(axis=1)
        return np.concatenate([mins, np.asarray([self.n_pages], np.uint64)])

    def page_extent(self, page: int) -> tuple[int, int]:
        off = self.arr(Sec.PAGE_OFFSET, np.uint64)[page]
        size = self.arr(Sec.PAGE_SIZE, np.uint64)[page]
        return int(off), int(size)

    def deletion_vector(self, page: int) -> np.ndarray | None:
        """Decoded DV: bool array of page_rows, True = deleted."""
        dvo = self.arr(Sec.DV_OFFSET, np.uint64)[page]
        if dvo == np.uint64(0xFFFFFFFFFFFFFFFF):
            return None
        size = int(self.arr(Sec.DV_SIZE, np.uint32)[page])
        rows = int(self.arr(Sec.PAGE_ROWS, np.uint32)[page])
        raw = np.frombuffer(self.raw(Sec.DV_DATA), np.uint8, count=size, offset=int(dvo))
        return np.unpackbits(raw, count=rows, bitorder="little").astype(bool)

    def props(self) -> dict[str, str]:
        if not self.has(Sec.PROPS):
            return {}
        parts = bytes(self.raw(Sec.PROPS)).split(b"\x00")
        return {parts[i].decode(): parts[i + 1].decode()
                for i in range(0, len(parts) - 1, 2)}


# -- metadata-cache invalidation hooks ---------------------------------------
#
# Higher layers may cache parsed footers keyed by path (the dataset layer's
# process-wide footer cache). Core-layer rewriters (``BullionWriter.close``,
# ``deletion.delete_rows``) must be able to invalidate those caches without
# importing upward, so cache owners register a callback here; with no cache
# ever imported the list stays empty and notification is a no-op.

_footer_invalidators: list = []


def register_footer_invalidator(fn) -> None:
    """Register ``fn(path)`` to be called whenever a Bullion file at
    ``path`` is rewritten in-process."""
    if fn not in _footer_invalidators:
        _footer_invalidators.append(fn)


def notify_footer_rewrite(path: str) -> None:
    """Tell every registered metadata cache that ``path`` was rewritten."""
    for fn in _footer_invalidators:
        fn(path)


def parse_footer(buf: bytes | memoryview, foot_off: int,
                 path: str) -> FooterView:
    """Construct a ``FooterView`` with torn-write structural validation.

    A crash mid-write (or a truncating copy) can leave a tail whose
    ``footer_len`` points at arbitrary bytes; naive ``FooterView``
    construction then produces struct-unpack garbage or views into
    nonsense extents. Every entry point that trusts a footer — local
    ``read_footer``, the backend's speculative-tail read — funnels
    through here so a torn file of any format version (v0–v3) surfaces
    as a typed ``ShardCorruptError`` instead."""
    if len(buf) < 4:
        raise ShardCorruptError(
            path, f"footer too small ({len(buf)} byte(s))")
    (n_sections,) = struct.unpack_from("<I", buf, len(buf) - 4)
    dir_bytes = n_sections * _DIR_ENTRY.size
    if dir_bytes + 4 > len(buf):
        raise ShardCorruptError(
            path, f"footer directory ({n_sections} section(s)) exceeds "
                  f"footer size {len(buf)}")
    try:
        fv = FooterView(buf)
    except (struct.error, ValueError) as e:  # pragma: no cover - belt
        raise ShardCorruptError(path, f"footer parse failed: {e}") from None
    payload_end = len(fv._buf) - 4 - dir_bytes
    for sid, (off, size) in fv._dir.items():
        if off < 0 or size < 0 or off + size > payload_end:
            raise ShardCorruptError(
                path, f"section {sid} extent [{off}, +{size}) outside "
                      f"footer payload [0, {payload_end})")
    if not fv.has(Sec.META) or len(fv.raw(Sec.META)) < 64:
        raise ShardCorruptError(path, "META section missing or short")
    if fv.has(Sec.PAGE_OFFSET) and fv.has(Sec.PAGE_SIZE):
        offs = fv.arr(Sec.PAGE_OFFSET, np.uint64)
        sizes = fv.arr(Sec.PAGE_SIZE, np.uint64)
        if len(offs) != len(sizes):
            raise ShardCorruptError(
                path, "PAGE_OFFSET / PAGE_SIZE length mismatch")
        if len(offs):
            # guard the uint64 add against wrap before trusting max()
            if int(offs.max()) > foot_off or int(sizes.max()) > foot_off:
                raise ShardCorruptError(
                    path, "data region truncated: page extent beyond the "
                          f"footer offset {foot_off}")
            end = int((offs + sizes).max())
            if end > foot_off:
                raise ShardCorruptError(
                    path, f"data region truncated: page data ends at {end} "
                          f"but the data region is [0, {foot_off})")
    return fv


def read_footer(path: str) -> tuple[FooterView, int]:
    """Read footer with two preads (tail, then footer) — the paper's access
    pattern. Returns (view, footer_offset). ``bullion://`` URIs route
    through their storage backend (one speculative tail GET) instead of the
    local filesystem, as do local paths while a chaos/test backend is
    registered for the ``file`` scheme (so fault injection covers footer
    reads too). Torn files raise ``ShardCorruptError``."""
    from . import backend as _backend
    if _backend.is_remote(path) or _backend.has_custom_local_backend():
        with _backend.open_shard(path) as h:
            return _backend.read_shard_footer(h)
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size < _TAIL.size:
            raise ShardCorruptError(
                path, f"file too small ({size} byte(s)) for a Bullion tail")
        f.seek(-_TAIL.size, 2)
        tail = f.read(_TAIL.size)
        flen, magic = _TAIL.unpack(tail)
        if magic != MAGIC:
            raise ShardCorruptError(
                path, "bad magic (not a Bullion file, or a torn write)")
        if flen + _TAIL.size > size:
            raise ShardCorruptError(
                path, f"footer length {flen} exceeds file size {size} "
                      "(truncated write)")
        foot_off = size - _TAIL.size - flen
        f.seek(foot_off)
        buf = f.read(flen)
    return parse_footer(buf, foot_off, path), foot_off
