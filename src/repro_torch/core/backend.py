"""Storage backends: where shard bytes come from.

The read path above this module is backend-agnostic — plans, pruning, and
decode only ever see page bytes. What varies is how a coalesced byte-range
run is fetched, so that is the whole protocol:

    ``StorageBackend.open(uri) -> ShardHandle``
    ``ShardHandle.size() / footer_tail(n) / pread(off, size)``
    ``ShardHandle.fetch_ranges(ranges, max_in_flight=) / validator() / close()``

Three implementations ship:

* **local pread** (``LocalBackend``) — a positional-read wrapper over a
  local file descriptor, byte-identical to reading the fd directly; the
  default for filesystem paths.
* **object-store ranged GETs** (``ObjectStoreBackend``) — resolves
  ``bullion://bucket/key`` URIs against an HTTP(S) endpoint
  (``configure_object_store()`` / ``BULLION_OBJECT_STORE``) with S3-style
  ``Range:`` requests, retry + capped exponential backoff + jitter on
  5xx/timeouts/truncation, and ETag/length identity for footer-cache
  validation (remote objects have no ``(mtime, size, inode)``).
* **async batched fetching** (``AsyncRangeFetcher``) — one event loop on a
  daemon thread that submits a whole batch of range GETs concurrently over
  pooled keep-alive connections with bounded in-flight requests, yielding
  results in *completion* order (asyncpg-style pipelining: the slowest
  range no longer serializes the batch). Remote handles route
  ``fetch_ranges`` through it automatically.

Accounting: remote fetches charge ``IOStats.backend_fetches`` /
``backend_retries`` / ``bytes_read`` through ``ShardHandle.bind_stats``
(local handles charge nothing — their reader keeps the exact pre-existing
``preads`` accounting), and every request feeds the always-on
``bullion.backend.*`` counters/histograms in the metrics registry.
"""

from __future__ import annotations

import asyncio
import http.client
import os
import queue
import random
import socket
import threading
import time
import urllib.parse
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

from ..obs import metrics as _metrics

SCHEME = "bullion://"
# remote holes are cheap relative to per-request latency: bridge up to 1 MiB
# (vs 64 KiB locally) so a wide projection becomes a handful of ranged GETs
REMOTE_COALESCE_GAP = 1024 * 1024
# the first footer read speculatively fetches this much object tail — enough
# for the 16-byte trailer plus effectively every real footer in one GET
SPECULATIVE_TAIL = 256 * 1024


def is_remote(path) -> bool:
    return isinstance(path, str) and path.startswith(SCHEME)


def parse_uri(uri: str) -> tuple[str, str]:
    """Split ``bullion://bucket/key...`` into ``(bucket, key)``."""
    rest = uri[len(SCHEME):]
    bucket, _, key = rest.partition("/")
    if not bucket or not key:
        raise ValueError(
            f"invalid object URI {uri!r} (expected bullion://bucket/key)")
    return bucket, key


# ---------------------------------------------------------------------------
# endpoint configuration
# ---------------------------------------------------------------------------

_endpoint_lock = threading.Lock()
_endpoint: Optional[str] = None


def configure_object_store(endpoint: Optional[str]) -> None:
    """Set (or clear, with ``None``) the process-wide object-store endpoint
    that ``bullion://`` URIs resolve against — an ``http(s)://host:port``
    base URL serving S3-style ranged GETs at ``/bucket/key``. Overrides the
    ``BULLION_OBJECT_STORE`` environment variable."""
    global _endpoint
    with _endpoint_lock:
        _endpoint = endpoint


def resolve_endpoint() -> str:
    with _endpoint_lock:
        ep = _endpoint
    ep = ep or os.environ.get("BULLION_OBJECT_STORE")
    if not ep or not ep.strip():
        raise FileNotFoundError(
            "no object-store endpoint configured for bullion:// URIs "
            "(call repro_torch.core.backend.configure_object_store() or set "
            "BULLION_OBJECT_STORE to an http(s)://host:port base URL)")
    return ep.strip().rstrip("/")


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

class _Retryable(Exception):
    """A transient backend failure (5xx, timeout, truncated body)."""


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with jitter for transient range-GET
    failures. 404 and connection-refused never retry — a missing key does
    not become present by waiting."""
    retries: int = 4           # attempts after the first = retries
    backoff_base: float = 0.05
    backoff_cap: float = 1.0
    jitter: float = 0.25       # ± fraction of the deterministic delay
    timeout: float = 10.0      # per-request wall clock

    @staticmethod
    def from_env() -> "RetryPolicy":
        env = os.environ.get
        return RetryPolicy(
            retries=int(env("BULLION_BACKEND_RETRIES", "4")),
            backoff_base=float(env("BULLION_BACKEND_BACKOFF", "0.05")),
            backoff_cap=float(env("BULLION_BACKEND_BACKOFF_CAP", "1.0")),
            timeout=float(env("BULLION_BACKEND_TIMEOUT", "10.0")))

    def delay(self, attempt: int) -> float:
        base = min(self.backoff_cap,
                   self.backoff_base * (2.0 ** max(0, attempt - 1)))
        return base * (1.0 + self.jitter * (2.0 * random.random() - 1.0))


# ---------------------------------------------------------------------------
# handles
# ---------------------------------------------------------------------------

class ShardHandle:
    """One open shard on some backend. ``bind_stats`` attaches the owning
    reader's ``IOStats`` so backend-level charges (fetches, retries, bytes)
    land on the same accounting every other read does."""

    uri: str
    is_remote = False

    def bind_stats(self, stats, lock) -> None:
        self._stats = stats
        self._stats_lock = lock

    def _charge(self, **fields) -> None:
        st = getattr(self, "_stats", None)
        if st is None:
            return
        with self._stats_lock:
            for k, v in fields.items():
                setattr(st, k, getattr(st, k) + v)

    # -- protocol ------------------------------------------------------------
    def size(self) -> int:
        raise NotImplementedError

    def pread(self, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def footer_tail(self, n: int) -> bytes:
        """The last ``min(n, size)`` bytes of the shard."""
        size = self.size()
        n = min(n, size)
        return self.pread(size - n, n)

    def validator(self) -> tuple:
        """Identity+version tuple for footer-cache validation."""
        raise NotImplementedError

    def fetch_ranges(self, ranges: Sequence[tuple[int, int]], *,
                     max_in_flight: int = 1
                     ) -> Iterator[tuple[int, Optional[bytes],
                                         Optional[BaseException]]]:
        """Fetch ``[(off, end), ...]``, yielding ``(index, data, error)``
        per range. The base implementation is serial and in submission
        order; remote handles overlap up to ``max_in_flight`` requests and
        yield in completion order. A failed range yields its error instead
        of raising, so one bad range only fails the work that needed it."""
        for i, (off, end) in enumerate(ranges):
            try:
                data = self.pread(off, end - off)
            except Exception as e:
                yield i, None, e
            else:
                yield i, data, None

    def close(self) -> None:
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LocalShardHandle(ShardHandle):
    """Local file via positional reads — exactly the fd-based access the
    reader always did, behind the protocol."""

    def __init__(self, path: str):
        self.uri = self.path = path
        self._f = open(path, "rb")

    @property
    def closed(self) -> bool:
        return self._f is None

    def size(self) -> int:
        return os.fstat(self._f.fileno()).st_size

    def pread(self, offset: int, size: int) -> bytes:
        f = self._f
        if f is None:
            raise ValueError(f"{self.path}: handle is closed")
        return os.pread(f.fileno(), size, offset)

    def validator(self) -> tuple:
        st = os.fstat(self._f.fileno())
        return (st.st_mtime_ns, st.st_size, st.st_ino)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class RemoteShardHandle(ShardHandle):
    """``bullion://bucket/key`` over HTTP(S) ranged GETs.

    The blocking path (``pread``, ``footer_tail``, ``stat``) runs on one
    keep-alive ``http.client`` connection per handle; batch fetches go
    through the shared :class:`AsyncRangeFetcher`. Errors map to the local
    filesystem's vocabulary: missing keys and unreachable endpoints raise
    ``FileNotFoundError``; exhausted transient retries raise ``OSError``.
    """

    is_remote = True

    def __init__(self, uri: str, *, endpoint: Optional[str] = None,
                 policy: Optional[RetryPolicy] = None):
        self.uri = uri
        bucket, key = parse_uri(uri)
        ep = endpoint or resolve_endpoint()
        u = urllib.parse.urlsplit(ep)
        if u.scheme not in ("http", "https") or not u.hostname:
            raise ValueError(
                f"object-store endpoint {ep!r} must be an "
                "http(s)://host:port base URL")
        self._https = u.scheme == "https"
        self._host = u.hostname
        self._port = u.port or (443 if self._https else 80)
        self._objpath = (u.path.rstrip("/") + "/"
                         + urllib.parse.quote(bucket) + "/"
                         + urllib.parse.quote(key))
        self.policy = policy or RetryPolicy.from_env()
        self._conn = None
        self._conn_lock = threading.Lock()
        self._closed = False
        self._size: Optional[int] = None
        self._etag: Optional[str] = None

    # -- raw request ---------------------------------------------------------
    def _request(self, method: str, headers: dict) -> tuple[int, dict, bytes]:
        with self._conn_lock:
            if self._closed:
                raise ValueError(f"{self.uri}: handle is closed")
            conn = self._conn
            self._conn = None
            if conn is None:
                cls = (http.client.HTTPSConnection if self._https
                       else http.client.HTTPConnection)
                conn = cls(self._host, self._port,
                           timeout=self.policy.timeout)
            try:
                conn.request(method, self._objpath, headers=headers)
                resp = conn.getresponse()
                body = resp.read()   # http.client raises IncompleteRead on
                                     # a body shorter than Content-Length
            except BaseException:
                conn.close()
                raise
            self._conn = conn
            return (resp.status,
                    {k.lower(): v for k, v in resp.getheaders()}, body)

    def _note_identity(self, hdrs: dict, *, head: bool) -> None:
        et = hdrs.get("etag")
        if et:
            self._etag = et
        cr = hdrs.get("content-range")   # "bytes a-b/total"
        if cr and "/" in cr:
            total = cr.rsplit("/", 1)[1].strip()
            if total.isdigit():
                self._size = int(total)
        elif head and "content-length" in hdrs:
            self._size = int(hdrs["content-length"])

    def _fetch(self, *, rng=None, suffix: Optional[int] = None,
               head: bool = False, what: str = "") -> bytes:
        """One object request with the handle's retry policy. ``rng`` is a
        half-open ``(off, end)``; ``suffix`` asks for the last N bytes."""
        headers = {}
        if rng is not None:
            headers["Range"] = f"bytes={rng[0]}-{rng[1] - 1}"
        elif suffix is not None:
            headers["Range"] = f"bytes=-{suffix}"
        method = "HEAD" if head else "GET"
        attempt = 0
        while True:
            attempt += 1
            t0 = time.perf_counter()
            err: Optional[BaseException] = None
            try:
                status, hdrs, body = self._request(method, headers)
            except (OSError, http.client.HTTPException) as e:
                status, hdrs, body, err = None, {}, b"", e
            if status == 404:
                raise FileNotFoundError(
                    f"object {self.uri} not found (HTTP 404 from "
                    f"{self._host}:{self._port})")
            if status in (200, 206):
                self._note_identity(hdrs, head=head)
                if head:
                    _metrics.counter("bullion.backend.heads").inc()
                    return body
                expect = None
                if rng is not None:
                    if status == 200:   # server ignored Range: slice locally
                        body = body[rng[0]:rng[1]]
                    expect = rng[1] - rng[0]
                elif suffix is not None and status == 200:
                    body = body[-suffix:]
                if expect is not None and len(body) != expect:
                    err = _Retryable(
                        f"short range body ({len(body)} of {expect} bytes)")
                else:
                    _metrics.counter("bullion.backend.fetches").inc()
                    _metrics.histogram("bullion.backend.fetch_seconds") \
                        .observe(time.perf_counter() - t0)
                    self._charge(backend_fetches=1, bytes_read=len(body))
                    return body
            elif status is not None:
                err = _Retryable(f"HTTP {status}")
            if isinstance(err, (ConnectionRefusedError, socket.gaierror)):
                raise FileNotFoundError(
                    f"object store for {self.uri} unreachable at "
                    f"{self._host}:{self._port} ({err})") from err
            if attempt > self.policy.retries:
                raise OSError(
                    f"{what or method} {self.uri} failed after {attempt} "
                    f"attempt(s): {err}") from err
            _metrics.counter("bullion.backend.retries").inc()
            self._charge(backend_retries=1)
            time.sleep(self.policy.delay(attempt))

    # -- protocol ------------------------------------------------------------
    def stat(self) -> tuple:
        """(ETag, length) via one HEAD — the remote footer-cache validator."""
        self._fetch(head=True, what="HEAD")
        return (self._etag, self._size)

    def validator(self) -> tuple:
        return self.stat()

    def size(self) -> int:
        if self._size is None:
            self.stat()
        return self._size

    def pread(self, offset: int, size: int) -> bytes:
        return self._fetch(rng=(offset, offset + size), what="range GET")

    def footer_tail(self, n: int) -> bytes:
        return self._fetch(suffix=n, what="footer tail GET")

    def fetch_ranges(self, ranges, *, max_in_flight: int = 1):
        if len(ranges) <= 1 or max_in_flight <= 1:
            yield from super().fetch_ranges(ranges,
                                            max_in_flight=max_in_flight)
            return
        yield from _fetcher().fetch(self, ranges,
                                    max_in_flight=max_in_flight)

    def close(self) -> None:
        with self._conn_lock:
            self._closed = True
            if self._conn is not None:
                self._conn.close()
                self._conn = None


# ---------------------------------------------------------------------------
# async batched fetcher
# ---------------------------------------------------------------------------

class AsyncRangeFetcher:
    """One event loop on a daemon thread, shared process-wide: a batch of
    range GETs is submitted concurrently (bounded by ``max_in_flight``) over
    pooled keep-alive connections, and results come back in completion
    order so decode overlaps the slowest range instead of waiting on it."""

    _POOL_CAP = 8   # idle keep-alive connections retained per endpoint

    def __init__(self):
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # (host, port, https) -> [(reader, writer)]; touched only on the
        # loop thread, so no extra locking
        self._pools: dict = {}

    def _ensure_loop(self) -> asyncio.AbstractEventLoop:
        with self._lock:
            if self._loop is None or self._thread is None \
                    or not self._thread.is_alive():
                self._loop = asyncio.new_event_loop()
                self._thread = threading.Thread(
                    target=self._loop.run_forever, daemon=True,
                    name="bullion-backend-loop")
                self._thread.start()
            return self._loop

    # -- public --------------------------------------------------------------
    def fetch(self, handle: RemoteShardHandle,
              ranges: Sequence[tuple[int, int]], *, max_in_flight: int):
        loop = self._ensure_loop()
        out: "queue.Queue" = queue.Queue()
        n = len(ranges)

        async def runner():
            sem = asyncio.Semaphore(max(1, int(max_in_flight)))
            in_flight = [0]

            async def one(i, off, end):
                async with sem:
                    in_flight[0] += 1
                    _metrics.histogram("bullion.backend.in_flight") \
                        .observe(in_flight[0])
                    try:
                        out.put((i, await self._get_range(handle, off, end),
                                 None))
                    except BaseException as e:
                        out.put((i, None, e))
                    finally:
                        in_flight[0] -= 1

            await asyncio.gather(
                *(one(i, off, end) for i, (off, end) in enumerate(ranges)),
                return_exceptions=True)

        fut = asyncio.run_coroutine_threadsafe(runner(), loop)
        try:
            for _ in range(n):
                yield out.get()
        finally:
            fut.cancel()

    # -- loop-side -----------------------------------------------------------
    async def _get_range(self, handle: RemoteShardHandle,
                         off: int, end: int) -> bytes:
        policy = handle.policy
        attempt = 0
        while True:
            attempt += 1
            t0 = time.perf_counter()
            try:
                data = await asyncio.wait_for(
                    self._request(handle, off, end), policy.timeout)
            except FileNotFoundError:
                raise
            except (OSError, EOFError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError, _Retryable) as e:
                if attempt > policy.retries:
                    raise OSError(
                        f"range GET {handle.uri} [{off}, {end}) failed "
                        f"after {attempt} attempt(s): {e}") from e
                _metrics.counter("bullion.backend.retries").inc()
                handle._charge(backend_retries=1)
                await asyncio.sleep(policy.delay(attempt))
            else:
                _metrics.counter("bullion.backend.fetches").inc()
                _metrics.histogram("bullion.backend.fetch_seconds") \
                    .observe(time.perf_counter() - t0)
                handle._charge(backend_fetches=1, bytes_read=len(data))
                return data

    async def _request(self, handle: RemoteShardHandle,
                       off: int, end: int) -> bytes:
        key = (handle._host, handle._port, handle._https)
        reader, writer = await self._acquire(key)
        try:
            writer.write((
                f"GET {handle._objpath} HTTP/1.1\r\n"
                f"Host: {handle._host}:{handle._port}\r\n"
                f"Range: bytes={off}-{end - 1}\r\n"
                "Connection: keep-alive\r\n\r\n").encode("ascii"))
            await writer.drain()
            status, hdrs = await self._read_head(reader)
            clen = int(hdrs.get(b"content-length", b"0"))
            body = await reader.readexactly(clen) if clen else b""
            if status == 404:
                raise FileNotFoundError(
                    f"object {handle.uri} not found (HTTP 404)")
            if status == 200:
                body = body[off:end]
            elif status != 206:
                raise _Retryable(f"HTTP {status}")
            if len(body) != end - off:
                raise _Retryable(
                    f"short range body ({len(body)} of {end - off} bytes)")
        except BaseException:
            writer.close()
            raise
        self._release(key, reader, writer)
        return body

    @staticmethod
    async def _read_head(reader) -> tuple[int, dict]:
        line = await reader.readline()
        parts = line.split(None, 2)
        if len(parts) < 2 or not parts[1].isdigit():
            raise _Retryable(f"malformed status line {line!r}")
        status = int(parts[1])
        hdrs: dict = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.partition(b":")
            hdrs[k.strip().lower()] = v.strip()
        return status, hdrs

    async def _acquire(self, key):
        pool = self._pools.setdefault(key, [])
        while pool:
            reader, writer = pool.pop()
            if not writer.is_closing() and not reader.at_eof():
                return reader, writer
            writer.close()
        host, port, https = key
        return await asyncio.open_connection(
            host, port, ssl=True if https else None)

    def _release(self, key, reader, writer) -> None:
        pool = self._pools.setdefault(key, [])
        if len(pool) < self._POOL_CAP and not writer.is_closing():
            pool.append((reader, writer))
        else:
            writer.close()


_FETCHER: Optional[AsyncRangeFetcher] = None
_fetcher_lock = threading.Lock()


def _fetcher() -> AsyncRangeFetcher:
    global _FETCHER
    if _FETCHER is None:
        with _fetcher_lock:
            if _FETCHER is None:
                _FETCHER = AsyncRangeFetcher()
    return _FETCHER


# ---------------------------------------------------------------------------
# backends + dispatch
# ---------------------------------------------------------------------------

class StorageBackend:
    """Protocol: ``open(uri) -> ShardHandle``; fetch semantics live on the
    handle. ``close()`` releases backend-wide resources (none by default)."""

    scheme = ""

    def open(self, uri: str) -> ShardHandle:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LocalBackend(StorageBackend):
    scheme = "file"

    def open(self, path: str) -> ShardHandle:
        return LocalShardHandle(path)


class ObjectStoreBackend(StorageBackend):
    scheme = "bullion"

    def __init__(self, endpoint: Optional[str] = None,
                 policy: Optional[RetryPolicy] = None):
        self._endpoint = endpoint
        self._policy = policy

    def open(self, uri: str) -> ShardHandle:
        return RemoteShardHandle(uri, endpoint=self._endpoint,
                                 policy=self._policy)


_LOCAL = LocalBackend()
_backends: dict[str, StorageBackend] = {}
_backends_lock = threading.Lock()


def register_backend(scheme: str, backend: StorageBackend) -> Optional[StorageBackend]:
    """Override the backend used for a scheme (tests, custom stores, the
    chaos fault-injection harness). ``"bullion"`` covers remote URIs;
    ``"file"`` covers plain local paths. Returns the previously registered
    backend (``None`` when the built-in default was active) so callers can
    restore it via ``unregister_backend(scheme, restore=prev)``."""
    with _backends_lock:
        prev = _backends.get(scheme)
        _backends[scheme] = backend
        return prev


def unregister_backend(scheme: str, *,
                       restore: Optional[StorageBackend] = None) -> None:
    """Drop a scheme override (or put back ``restore``, a previous
    ``register_backend`` return value)."""
    with _backends_lock:
        if restore is None:
            _backends.pop(scheme, None)
        else:
            _backends[scheme] = restore


def has_custom_local_backend() -> bool:
    """True while a ``file``-scheme override is registered — local footer
    reads then route through the backend protocol so fault injection sees
    them."""
    with _backends_lock:
        return "file" in _backends


def backend_for(path: str) -> StorageBackend:
    if is_remote(path):
        with _backends_lock:
            be = _backends.get("bullion")
        return be if be is not None else ObjectStoreBackend()
    with _backends_lock:
        be = _backends.get("file")
    return be if be is not None else _LOCAL


def open_shard(path: str) -> ShardHandle:
    """Open ``path`` (a filesystem path or ``bullion://`` URI) on its
    backend."""
    return backend_for(path).open(path)


def read_shard_footer(handle: ShardHandle, *,
                      speculative_tail: int = SPECULATIVE_TAIL):
    """Footer via the backend protocol: one speculative tail fetch covers
    the 16-byte trailer and (in practice) the whole footer; a second exact
    range read happens only when the footer outgrows the speculation.
    Returns ``(FooterView, footer_offset)`` like ``read_footer``."""
    from .footer import _TAIL, MAGIC, ShardCorruptError, parse_footer
    tail = handle.footer_tail(max(_TAIL.size, int(speculative_tail)))
    if len(tail) < _TAIL.size:
        raise ShardCorruptError(
            handle.uri,
            f"object too small ({len(tail)} byte(s)) for a Bullion tail")
    flen, magic = _TAIL.unpack(tail[-_TAIL.size:])
    if magic != MAGIC:
        raise ShardCorruptError(
            handle.uri, "bad magic (not a Bullion object, or a torn write)")
    size = handle.size()
    foot_off = size - _TAIL.size - flen
    if foot_off < 0:
        raise ShardCorruptError(
            handle.uri,
            f"footer length {flen} exceeds object size {size} "
            "(truncated write)")
    if flen + _TAIL.size <= len(tail):
        buf = tail[len(tail) - _TAIL.size - flen: len(tail) - _TAIL.size]
    else:
        buf = handle.pread(foot_off, flen)
    return parse_footer(bytes(buf), foot_off, handle.uri), foot_off
