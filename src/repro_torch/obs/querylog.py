"""Structured per-query records: the service's flight recorder.

Every query the serving stack executes — ``DatasetServer.query/submit``
and, when enabled, local ``Dataset`` terminals — appends one
``QueryRecord`` to a thread-safe bounded ``QueryLog``: who asked (tenant),
what ran (dataset, plan fingerprint, cache hit/miss), what it cost
(per-stage timings from a scoped tracer, the exact ``IOStats`` delta the
execution charged, row/byte counts), and how it ended (outcome ``"ok"`` or
``"error"`` + message). The log is the substrate ``server.stats()``
summaries, the ``bullion log`` CLI, and post-hoc debugging read from.

Environment knobs (read when a ``QueryLog`` is constructed):

* ``BULLION_QUERY_LOG=path`` — mirror every record to a JSONL sink (one
  JSON object per line, append-only) *and* enable local-run recording in
  ``Dataset._execute`` (the serve path always records into the server's
  bounded log; the sink is how a benchmark or training run leaves one).
* ``BULLION_SLOW_MS=n`` — slow-query threshold. The serve path runs each
  query under a scoped tracer when set, and any query slower than ``n``
  milliseconds gets its *full span list* promoted into the record, so the
  one query that blew the latency budget arrives with its own trace
  attached.

Stdlib-only (no repro imports) like the rest of ``repro_torch.obs``: any layer
may record without cycles. ``IOStats`` deltas arrive as plain dicts
(``dataclasses.asdict``) for the same reason.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from .trace import StageAgg, _arg_safe

_DEFAULT_CAPACITY = 256


def _env_sink() -> Optional[str]:
    path = os.environ.get("BULLION_QUERY_LOG")
    return path.strip() if path and path.strip() else None


def _env_slow_seconds() -> Optional[float]:
    env = os.environ.get("BULLION_SLOW_MS")
    if env is None or not env.strip():
        return None
    try:
        ms = float(env)
    except ValueError:
        raise ValueError(
            f"BULLION_SLOW_MS must be a millisecond threshold, "
            f"got {env!r}") from None
    if ms < 0:
        raise ValueError(f"BULLION_SLOW_MS must be >= 0, got {ms}")
    return ms / 1e3


def stage_dict(agg: dict[str, StageAgg]) -> dict:
    """Tracer aggregate -> plain JSON-able dict (per-stage call count,
    summed seconds, summed numeric args)."""
    return {name: {"calls": a.count, "seconds": a.seconds,
                   **{k: _arg_safe(v) for k, v in a.args.items()}}
            for name, a in agg.items()}


@dataclass
class QueryRecord:
    """One executed (or failed) query, fully structured."""

    ts: float                               # wall-clock epoch seconds
    origin: str                             # "serve" | "local" | "serve.wire"
    dataset: str
    tenant: str = "default"
    fingerprint: Optional[str] = None       # LogicalPlan.fingerprint()
    cache_hit: Optional[bool] = None        # prepared-plan cache (serve only)
    columns: Optional[list] = None
    predicate: Optional[str] = None         # repr of the predicate, if any
    rows: int = 0                           # rows returned
    result_bytes: int = 0                   # payload bytes returned
    wall_seconds: float = 0.0
    outcome: str = "ok"                     # "ok" | "error"
    error: Optional[str] = None
    degraded: bool = False                  # quarantined pages dropped/masked
                                            # rows (io["degraded_rows"] > 0)
    io: Optional[dict] = None               # exact IOStats delta (asdict)
    stages: Optional[dict] = None           # scoped-tracer aggregate
    trace_id: Optional[str] = None          # wire-propagated trace id
    dropped_spans: int = 0
    slow: bool = False                      # crossed BULLION_SLOW_MS
    spans: Optional[list] = field(default=None, repr=False)  # promoted tree

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in self.__dataclass_fields__}
        return d

    def __repr__(self) -> str:
        tail = "" if self.outcome == "ok" else f" error={self.error!r}"
        return (f"QueryRecord({self.origin} {self.dataset!r} "
                f"rows={self.rows} wall={self.wall_seconds * 1e3:.3f}ms "
                f"outcome={self.outcome}{tail})")


class QueryLog:
    """Thread-safe bounded ring of ``QueryRecord`` + optional JSONL sink.

    Appends are one lock + one deque push; the sink (when configured)
    appends one JSON line per record under the same lock, so lines from
    concurrent sessions never interleave. Sink failures are reported once
    to stderr and disable the sink — telemetry must never fail a query.
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY, *,
                 sink_path: Optional[str] = None,
                 slow_seconds: Optional[float] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.sink_path = _env_sink() if sink_path is None else sink_path
        self.slow_seconds = _env_slow_seconds() \
            if slow_seconds is None else slow_seconds
        self._recs: "deque[QueryRecord]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._sink = None
        self._sink_failed = False
        self.total = 0               # records ever appended (ring evicts)
        self.errors = 0
        self.slow = 0
        self.degraded = 0            # records that dropped/masked rows

    def append(self, rec: QueryRecord) -> QueryRecord:
        if self.slow_seconds is not None \
                and rec.wall_seconds >= self.slow_seconds:
            rec.slow = True
        with self._lock:
            self._recs.append(rec)
            self.total += 1
            if rec.outcome != "ok":
                self.errors += 1
            if rec.slow:
                self.slow += 1
            if rec.degraded:
                self.degraded += 1
            self._sink_write(rec)
        return rec

    def _sink_write(self, rec: QueryRecord) -> None:
        if self.sink_path is None or self._sink_failed:
            return
        try:
            if self._sink is None:
                self._sink = open(self.sink_path, "a")
            json.dump(rec.to_dict(), self._sink)
            self._sink.write("\n")
            self._sink.flush()
        except OSError as e:
            self._sink_failed = True
            print(f"bullion: query-log sink {self.sink_path!r} failed: {e}",
                  file=sys.stderr)

    def records(self) -> list[QueryRecord]:
        """Snapshot, oldest first."""
        with self._lock:
            return list(self._recs)

    def tail(self, n: int = 20) -> list[QueryRecord]:
        with self._lock:
            return list(self._recs)[-max(0, int(n)):]

    def clear(self) -> None:
        with self._lock:
            self._recs.clear()

    def summary(self) -> dict:
        """Folded view for ``server.stats()``: totals plus a per-dataset
        breakdown of the records still in the ring."""
        with self._lock:
            recs = list(self._recs)
            total, errors, slow = self.total, self.errors, self.slow
            degraded = self.degraded
        by_ds: dict[str, dict] = {}
        for r in recs:
            d = by_ds.setdefault(r.dataset, {"queries": 0, "errors": 0,
                                             "degraded": 0, "rows": 0,
                                             "wall_seconds": 0.0})
            d["queries"] += 1
            d["rows"] += r.rows
            d["wall_seconds"] += r.wall_seconds
            if r.outcome != "ok":
                d["errors"] += 1
            if r.degraded:
                d["degraded"] += 1
        return {"total": total, "errors": errors, "slow": slow,
                "degraded": degraded, "retained": len(recs),
                "capacity": self.capacity, "by_dataset": by_ds}

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:
                    pass
                self._sink = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._recs)


# ---------------------------------------------------------------------------
# the process-wide log local Dataset terminals record into
# ---------------------------------------------------------------------------

LOG = QueryLog()

_local = False


def enable_local(on: bool = True) -> None:
    """Turn local-run recording (``Dataset._execute``) on without the
    ``BULLION_QUERY_LOG`` env (records stay in the in-process ring)."""
    global _local
    _local = on


def local_enabled() -> bool:
    """Should local ``Dataset`` terminals record? True when a JSONL sink
    is configured or recording was enabled programmatically — the default
    (both off) keeps the local hot path record-free."""
    return _local or LOG.sink_path is not None


def now() -> float:
    return time.time()
