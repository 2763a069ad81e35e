"""In-process fake object store: S3-style ranged GETs over a directory.

A ``ThreadingHTTPServer`` on a loopback ephemeral port serves files under a
root directory as ``/bucket/key`` objects with HTTP/1.1 keep-alive, byte
``Range:`` requests (absolute and suffix forms), ``Content-Range``, and
``ETag`` headers — everything ``repro_torch.core.backend`` needs, nothing more.

Fault injection (``inject``) queues per-request schedules applied to the
next data range GETs: an error status, a truncated body (the server
advertises the full ``Content-Length`` then drops the connection
mid-body), a silently corrupted body (one byte flipped, length and
headers truthful — only checksum verification catches it), or an
override latency. A uniform per-request ``latency`` models
object-store RTT; ``max_in_flight`` records the high-water mark of
concurrently served requests so tests can assert the async batcher really
overlapped its ranges.
"""

from __future__ import annotations

import http.server
import os
import socket
import threading
import time
import urllib.parse
from collections import deque
from typing import Callable, Optional, Union


class FakeObjectStore:
    """Serve ``root/bucket/key`` files at ``http://127.0.0.1:<port>``."""

    def __init__(self, root: str, *,
                 latency: Union[float, Callable[[], float]] = 0.0):
        self.root = os.path.abspath(root)
        self.latency = latency
        self.requests = 0           # every request served
        self.range_requests = 0     # data GETs carrying a Range: header
        self.head_requests = 0
        self.max_in_flight = 0      # high-water concurrent requests
        self._in_flight = 0
        self._lock = threading.Lock()
        self._faults: "deque[dict]" = deque()
        self._server: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> str:
        store = self

        class Handler(http.server.BaseHTTPRequestHandler):
            # HTTP/1.1 + exact Content-Length keeps connections alive, which
            # is what the client's pooling and the truncation fault rely on
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):   # keep test output clean
                pass

            def do_HEAD(self):
                store._serve(self, head=True)

            def do_GET(self):
                store._serve(self, head=False)

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                       Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name="bullion-fake-objstore")
        self._thread.start()
        return self.endpoint

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join()
            self._server = self._thread = None

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def __enter__(self) -> "FakeObjectStore":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def uri(self, relpath: str) -> str:
        """``bullion://`` URI for a path relative to the store root."""
        return "bullion://" + relpath.replace(os.sep, "/")

    # -- fault schedule ------------------------------------------------------
    def inject(self, *, count: int = 1, status: Optional[int] = None,
               truncate: Optional[float] = None,
               corrupt: bool = False,
               latency: Optional[float] = None) -> None:
        """Apply a fault to each of the next ``count`` data range GETs:
        respond ``status`` (e.g. 503), send only ``truncate`` fraction of
        the advertised body then drop the connection, flip one body byte
        (``corrupt=True`` — length and headers stay truthful, so only a
        checksum can tell), and/or override the per-request ``latency``."""
        for _ in range(count):
            self._faults.append({"status": status, "truncate": truncate,
                                 "corrupt": corrupt, "latency": latency})

    def clear_faults(self) -> None:
        self._faults.clear()

    # -- serving -------------------------------------------------------------
    def _resolve(self, urlpath: str) -> Optional[str]:
        rel = os.path.normpath(
            urllib.parse.unquote(urllib.parse.urlsplit(urlpath).path)
            .lstrip("/"))
        if rel.startswith("..") or os.path.isabs(rel):
            return None
        path = os.path.join(self.root, rel)
        return path if os.path.isfile(path) else None

    def _serve(self, h, *, head: bool) -> None:
        rng = h.headers.get("Range")
        with self._lock:
            self.requests += 1
            if head:
                self.head_requests += 1
            fault = None
            if not head and rng is not None:
                self.range_requests += 1
                if self._faults:
                    fault = self._faults.popleft()
            self._in_flight += 1
            self.max_in_flight = max(self.max_in_flight, self._in_flight)
        try:
            self._serve_inner(h, head=head, rng=rng, fault=fault)
        except (BrokenPipeError, ConnectionResetError):
            pass   # client went away mid-response
        finally:
            with self._lock:
                self._in_flight -= 1

    def _serve_inner(self, h, *, head: bool, rng: Optional[str],
                     fault: Optional[dict]) -> None:
        lat = self.latency
        if fault and fault.get("latency") is not None:
            lat = fault["latency"]
        if lat:
            time.sleep(lat() if callable(lat) else lat)

        path = self._resolve(h.path)
        if path is None:
            body = b"no such object"
            h.send_response(404)
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            if not head:
                h.wfile.write(body)
            return

        st = os.stat(path)
        etag = f'"{st.st_mtime_ns:x}-{st.st_size:x}"'
        if fault and fault.get("status"):
            body = b"injected fault"
            h.send_response(fault["status"])
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
            return

        if head:
            h.send_response(200)
            h.send_header("Content-Length", str(st.st_size))
            h.send_header("ETag", etag)
            h.send_header("Accept-Ranges", "bytes")
            h.end_headers()
            return

        start, end, status = 0, st.st_size, 200   # [start, end)
        if rng:
            spec = rng.split("=", 1)[1].strip()
            if spec.startswith("-"):               # suffix form: last N bytes
                start = max(0, st.st_size - int(spec[1:]))
            else:
                a, _, b = spec.partition("-")
                start = int(a)
                end = min(st.st_size, int(b) + 1) if b else st.st_size
            status = 206
        with open(path, "rb") as f:
            f.seek(start)
            body = f.read(end - start)
        if fault and fault.get("corrupt") and body:
            # silent in-flight corruption: flip the middle byte, keep the
            # advertised Content-Length — only checksum verification can
            # catch this one
            flipped = bytearray(body)
            flipped[len(flipped) // 2] ^= 0xFF
            body = bytes(flipped)

        h.send_response(status)
        h.send_header("Content-Length", str(len(body)))
        h.send_header("ETag", etag)
        if status == 206:
            h.send_header("Content-Range",
                          f"bytes {start}-{end - 1}/{st.st_size}")
        h.end_headers()
        if fault and fault.get("truncate") is not None:
            # advertise the full length, send a prefix, drop the connection:
            # the client must detect the short body and retry
            h.wfile.write(body[:int(len(body) * fault["truncate"])])
            h.wfile.flush()
            h.close_connection = True
            try:
                h.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            return
        h.wfile.write(body)
