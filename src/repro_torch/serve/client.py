"""Client for the ``DatasetServer`` AF_UNIX front-end.

One socket per client; requests on a connection are serialized (the
protocol is strict request/response). Predicates are built with the normal
``repro_torch.scan.C`` combinators and serialized structurally::

    with ServeClient(path) as cli:
        res = cli.query("ads", where=C("id") == 12345,
                        columns=["ctr", "bid"])
        res.table["ctr"]        # numpy array, decoded

Spin up several clients (or threads each owning one) for concurrency —
the server is thread-per-session and all sessions share its bounded pool.

``ServeClient(path, trace=True)`` turns on cross-process trace
propagation: the client stamps its trace id into every request frame,
wraps each RPC in a client-side span, and the server executes the query
under a scoped tracer whose finished spans ride back on the response
(wall-clock timestamps, rebased on arrival). ``profile()`` merges both
sides into one Perfetto-loadable Chrome trace under the one trace id —
the client's ``client.rpc`` spans enclose the server's ``serve.query``
span trees, so the wire/queueing gap is visible as the difference.
"""

from __future__ import annotations

import socket
import threading
import uuid
from dataclasses import dataclass
from typing import Optional, Sequence

from ..obs import trace as _trace
from ..obs.export import Profile
from ..scan.predicate import Predicate
from . import wire

# server spans keep their own thread ids; the offset keeps their tracks
# separate from client threads in the merged trace even across processes
# that happen to reuse a tid
_SERVER_TID_OFFSET = 1 << 24


class ServeError(RuntimeError):
    """The server answered a request with ok=False."""


@dataclass
class ClientResult:
    table: dict
    rows: int
    cache_hit: bool
    fingerprint: str
    wall_seconds: float
    trace_id: Optional[str] = None
    degraded: bool = False        # server dropped/masked quarantined pages
    degraded_rows: int = 0


class ServeClient:
    def __init__(self, socket_path: str, *, timeout: Optional[float] = 30.0,
                 trace: bool = False):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        self._sock.connect(socket_path)
        self._lock = threading.Lock()   # one in-flight request per socket
        self.trace_id: Optional[str] = None
        self._tracer: Optional[_trace.Tracer] = None
        self._server_spans: list[_trace.SpanRecord] = []
        if trace:
            self.trace_id = uuid.uuid4().hex[:16]
            self._tracer = _trace.Tracer()

    def _rpc(self, req: dict) -> dict:
        if self._tracer is not None:
            sp = self._tracer.span("client.rpc", "serve",
                                   {"op": req.get("op"),
                                    "trace_id": self.trace_id})
            if "dataset" in req:
                sp.set(dataset=req["dataset"])
            with sp:
                resp = self._roundtrip(req)
        else:
            resp = self._roundtrip(req)
        if resp is None:
            raise ConnectionError("server closed the connection")
        self._absorb_trace(resp)
        if not resp.get("ok"):
            raise ServeError(resp.get("error", "unknown server error"))
        return resp

    def _roundtrip(self, req: dict) -> Optional[dict]:
        with self._lock:
            wire.send_msg(self._sock, req)
            return wire.recv_msg(self._sock)

    def _absorb_trace(self, resp: dict) -> None:
        tr = resp.get("trace")
        if not tr:
            return
        for d in tr.get("spans", []):
            rec = _trace.span_from_dict(d, wall=True)
            rec.tid += _SERVER_TID_OFFSET
            rec.tname = f"server:{rec.tname}"
            self._server_spans.append(rec)

    def ping(self) -> bool:
        return bool(self._rpc({"op": "ping"}).get("pong"))

    def datasets(self) -> list[str]:
        return self._rpc({"op": "datasets"})["datasets"]

    def stats(self) -> dict:
        return self._rpc({"op": "stats"})["stats"]

    def metrics_text(self) -> str:
        """The server's metrics registry in Prometheus text format."""
        return self._rpc({"op": "metrics"})["text"]

    def server_log(self, n: int = 50) -> list[dict]:
        """The server's most recent query-log records (plain dicts)."""
        return self._rpc({"op": "log", "n": n})["records"]

    def explain(self, dataset: str, *,
                columns: Optional[Sequence[str]] = None,
                where: Optional[Predicate] = None,
                head: Optional[int] = None) -> str:
        return self._rpc({"op": "explain", "dataset": dataset,
                          "columns": list(columns) if columns else None,
                          "where": wire.encode_predicate(where),
                          "head": head})["explain"]

    def query(self, dataset: str, *,
              columns: Optional[Sequence[str]] = None,
              where: Optional[Predicate] = None,
              head: Optional[int] = None,
              tenant: str = "default",
              io_depth: Optional[int] = None) -> ClientResult:
        req = {"op": "query", "dataset": dataset,
               "columns": list(columns) if columns else None,
               "where": wire.encode_predicate(where),
               "head": head, "tenant": tenant,
               "io_depth": io_depth}
        if self.trace_id is not None:
            req["trace"] = {"id": self.trace_id}
        resp = self._rpc(req)
        return ClientResult(table=wire.decode_table(resp["table"]),
                            rows=resp["rows"],
                            cache_hit=resp["cache_hit"],
                            fingerprint=resp["fingerprint"],
                            wall_seconds=resp["wall_seconds"],
                            trace_id=self.trace_id,
                            degraded=bool(resp.get("degraded")),
                            degraded_rows=int(resp.get("degraded_rows") or 0))

    def profile(self, path: Optional[str] = None) -> Profile:
        """Merge the client-side RPC spans with every server span this
        connection's traced queries brought back into one ``Profile``
        (single Chrome trace, one trace id). ``path`` writes the JSON —
        load it in Perfetto / chrome://tracing. Requires ``trace=True``."""
        if self._tracer is None:
            raise RuntimeError(
                "profile() needs ServeClient(..., trace=True)")
        spans = list(self._tracer.spans) + list(self._server_spans)
        spans.sort(key=lambda s: s.ts)
        prof = Profile.from_spans(spans, dropped=self._tracer.dropped,
                                  trace_id=self.trace_id)
        if path is not None:
            prof.write(path)
        return prof

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
