"""Chaos fault-injection harness for the self-healing read path.

Wraps any ``ShardHandle`` (local or remote) behind the storage-backend
registry and injects the storage failures the integrity layer exists to
survive, deterministically and per-operation::

    from repro_torch.testing.chaos import chaos

    with chaos() as ctl:                       # hooks plain local paths
        ctl.inject("bitflip", path_sub="part-00000", ordinal=0, byte=5)
        ds = dataset(path)
        ds.select("q").to_table()              # first pread comes back bad

Fault kinds:

* ``bitflip``  — XOR one byte of the returned blob (``byte`` indexes into
  it; negative indexes from the end),
* ``truncate`` — return only the first ``keep`` fraction of the blob,
* ``eio``      — raise ``OSError(EIO)`` instead of returning data,
* ``stale_footer`` — replay the *first* footer tail ever served for the
  path on every later ``footer_tail`` read, simulating a reader racing a
  shard rewrite with a stale cached footer.

Targeting: a fault fires on the ``ordinal``-th (0-based) matching
operation against a path containing ``path_sub``, counted per
``(path, section)`` where section is ``"pread"`` (data reads, including
each range of a ``fetch_ranges`` batch) or ``"footer"`` (tail reads).
``times`` widens the window to several consecutive operations (``-1`` =
every one from ``ordinal`` on). Counters and faults live on the
``ChaosController``, so one controller scripts a whole scenario and
``fired`` counts prove each fault actually hit.

The harness installs itself with ``register_backend`` — the same seam the
object-store backend uses — so every layer above (reader, prefetcher,
footer cache, fsck) is exercised unmodified. ``chaos()`` restores the
previous backends and drops the process-wide footer cache on exit, so a
footer read under chaos never leaks into the next test.
"""

from __future__ import annotations

import errno
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

from ..core import backend as _backend
from ..core.backend import ShardHandle, StorageBackend

_KINDS = ("bitflip", "truncate", "eio", "stale_footer")
_SECTIONS = ("pread", "footer")


@dataclass
class Fault:
    """One scripted failure; ``fired`` counts the operations it hit."""

    kind: str
    path_sub: str = ""          # substring of the shard path/uri; "" = any
    section: str = "pread"      # which operation class it attaches to
    ordinal: int = 0            # fire on the Nth matching op (0-based)
    times: int = 1              # consecutive ops affected; -1 = all onward
    byte: int = 0               # bitflip: index into the returned blob
    keep: float = 0.5           # truncate: fraction of the blob kept
    fired: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_KINDS}")
        if self.section not in _SECTIONS:
            raise ValueError(f"unknown section {self.section!r}; "
                             f"expected one of {_SECTIONS}")

    def _matches(self, path: str, section: str, count: int) -> bool:
        if self.section != section or self.path_sub not in path:
            return False
        if count < self.ordinal:
            return False
        return self.times < 0 or count < self.ordinal + self.times


def _apply(fault: Fault, data: bytes) -> bytes:
    """Corrupt ``data`` per the fault. EIO is handled by the caller (it
    replaces the read instead of mangling its result)."""
    if fault.kind == "bitflip" and data:
        i = fault.byte if fault.byte >= 0 else len(data) + fault.byte
        i = max(0, min(len(data) - 1, i))
        out = bytearray(data)
        out[i] ^= 0xFF
        return bytes(out)
    if fault.kind == "truncate":
        return data[:max(0, int(len(data) * fault.keep))]
    return data


class ChaosController:
    """Owns the fault script and the per-(path, section) operation
    counters every wrapped handle reports into."""

    def __init__(self):
        self._lock = threading.Lock()
        self._faults: list[Fault] = []
        self._counts: dict[tuple[str, str], int] = {}
        self._tails: dict[str, bytes] = {}   # stale_footer first-served

    def inject(self, kind: str, **kw) -> Fault:
        f = Fault(kind, **kw)
        with self._lock:
            self._faults.append(f)
        return f

    def clear(self) -> None:
        with self._lock:
            self._faults.clear()
            self._counts.clear()
            self._tails.clear()

    @property
    def faults(self) -> list[Fault]:
        with self._lock:
            return list(self._faults)

    def take(self, path: str, section: str) -> list[Fault]:
        """Advance the (path, section) counter by one operation and return
        the faults that fire on it (marked fired)."""
        with self._lock:
            key = (path, section)
            count = self._counts.get(key, 0)
            self._counts[key] = count + 1
            hits = [f for f in self._faults
                    if f._matches(path, section, count)]
            for f in hits:
                f.fired += 1
            return hits

    def _stale_tail(self, path: str, tail: bytes,
                    active: bool) -> bytes:
        """First-served replay: remember the first tail per path; when a
        stale_footer fault is active, serve the remembered one."""
        with self._lock:
            first = self._tails.setdefault(path, tail)
        return first if active else tail

    def wrap(self, handle: ShardHandle) -> "ChaosShardHandle":
        return ChaosShardHandle(handle, self)


class ChaosShardHandle(ShardHandle):
    """Transparent proxy that routes every read through the controller."""

    def __init__(self, inner: ShardHandle, ctl: ChaosController):
        self._inner = inner
        self._ctl = ctl
        self.uri = inner.uri
        self.is_remote = inner.is_remote

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def bind_stats(self, stats, lock) -> None:
        self._inner.bind_stats(stats, lock)

    def _serve(self, data: bytes, hits: list[Fault]) -> bytes:
        for f in hits:
            if f.kind == "eio":
                raise OSError(errno.EIO, f"chaos: injected EIO "
                                         f"({self.uri})")
            data = _apply(f, data)
        return data

    def size(self) -> int:
        return self._inner.size()

    def pread(self, offset: int, size: int) -> bytes:
        hits = self._ctl.take(self.uri, "pread")
        return self._serve(self._inner.pread(offset, size), hits)

    def footer_tail(self, n: int) -> bytes:
        hits = self._ctl.take(self.uri, "footer")
        tail = self._inner.footer_tail(n)
        stale = any(f.kind == "stale_footer" for f in hits)
        tail = self._ctl._stale_tail(self.uri, tail, stale)
        return self._serve(tail, [f for f in hits
                                  if f.kind != "stale_footer"])

    def validator(self) -> tuple:
        return self._inner.validator()

    def fetch_ranges(self, ranges: Sequence[tuple[int, int]], *,
                     max_in_flight: int = 1
                     ) -> Iterator[tuple[int, Optional[bytes],
                                         Optional[BaseException]]]:
        # one "pread" operation per range, counted at submission order so
        # ordinals stay deterministic even when completions reorder
        plans = [self._ctl.take(self.uri, "pread") for _ in ranges]
        for i, data, err in self._inner.fetch_ranges(
                ranges, max_in_flight=max_in_flight):
            if err is None:
                try:
                    data = self._serve(data, plans[i])
                except OSError as e:
                    data, err = None, e
            yield i, data, err

    def close(self) -> None:
        self._inner.close()


@dataclass
class ChaosBackend(StorageBackend):
    """Backend decorator: opens on the inner backend, wraps the handle."""

    inner: StorageBackend
    ctl: ChaosController = field(default_factory=ChaosController)

    def open(self, uri: str) -> ShardHandle:
        return self.ctl.wrap(self.inner.open(uri))

    def close(self) -> None:
        self.inner.close()


@contextmanager
def chaos(schemes: Sequence[str] = ("file",), *,
          controller: Optional[ChaosController] = None):
    """Install fault injection for ``schemes`` (``"file"`` hooks plain
    local paths, ``"bullion"`` hooks object-store URIs) and yield the
    ``ChaosController``. Restores the previous backends and clears the
    process-wide footer cache on exit."""
    ctl = controller if controller is not None else ChaosController()
    prev: dict[str, Optional[StorageBackend]] = {}
    for scheme in schemes:
        inner = _backend._backends.get(scheme)
        if inner is None:
            inner = _backend._LOCAL if scheme == "file" \
                else _backend.ObjectStoreBackend()
        prev[scheme] = _backend.register_backend(
            scheme, ChaosBackend(inner, ctl))
    try:
        yield ctl
    finally:
        for scheme, p in prev.items():
            _backend.unregister_backend(scheme, restore=p)
        from ..dataset.source import clear_footer_cache
        clear_footer_cache()
