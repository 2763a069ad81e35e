"""Multi-tenant dataset service: prepared plans, admission control, probes.
Ported from ``repro.serve.server``; a server has one device, where every
prepared plan runs its range filter and its dequantize (``device``,
default ``cuda``; ``"cpu"`` for the plain versions).

``DatasetServer`` fronts one or more Bullion datasets for the paper's
feature-serving workload — many concurrent point probes and narrow
projections against wide tables. Three mechanisms make it a *service*
rather than a loop around ``dataset()``:

* **Prepared plans.** Query shapes repeat (dashboards, feature fetchers),
  so optimized plans are cached in an LRU keyed by (dataset, plan
  fingerprint) — à la prepared statements. A hit reuses a ``Dataset``
  instance whose optimize/lower caches are already populated: the repeat
  query pays zero planning, only execution. ``LogicalPlan.fingerprint``
  normalizes conjunct order, so ``.where(a).where(b)`` and
  ``.where(b).where(a)`` share one entry.
* **Shared metadata and descriptors.** All sessions read through one
  ``DataSource`` per dataset: one parsed footer and one fd per shard,
  however many clients connect (positional preads are thread-safe).
* **Admission control.** A bounded executor pool caps global concurrency;
  queue depth is observed into ``bullion.serve.queue_depth`` at every
  submit. Per-tenant ``io_depth`` budgets cap the *sum of io_depths* a
  tenant's in-flight queries may hold, bounding its concurrent preads —
  a noisy tenant queues against its own budget, not the fleet's.

Clients use the in-process API (``query``/``submit``) or the thread-per-
session AF_UNIX front-end (``serve`` + ``repro_torch.serve.client.ServeClient``).

Point probes with *varying* literals fingerprint differently by design —
group pruning is literal-dependent, so lowering must rerun — but they still
ride the shared footer cache and the bloom sketches; the prepared cache is
for the repeated-identical-plan case, which is asserted in tests.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import tempfile
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Sequence

from .. import resolve_device
from ..core import integrity as _integrity
from ..dataset import executor
from ..dataset.core import Dataset
from ..dataset.plan import LogicalPlan
from ..dataset.source import DataSource, PathSpec, discover
from ..obs import metrics as _metrics
from ..obs import querylog as _querylog
from ..obs import trace as _trace
from ..obs.expose import prometheus_text
from ..scan.predicate import Predicate
from . import wire

DEFAULT_TENANT = "default"


def _table_rows(table: dict) -> int:
    for col in table.values():
        return len(col)
    return 0


@dataclass
class QueryResult:
    table: dict
    rows: int
    cache_hit: bool              # served from the prepared-plan cache
    fingerprint: str
    wall_seconds: float
    tenant: str = DEFAULT_TENANT
    trace_id: Optional[str] = None
    spans: Optional[list] = None  # wall-ts span dicts (wire trace requests)
    degraded: bool = False        # quarantined pages degraded this result
    degraded_rows: int = 0        # exact rows dropped/masked (IOStats delta)


@dataclass
class _Prepared:
    ds: Dataset
    fingerprint: str
    hits: int = 0


class PlanCache:
    """LRU of prepared ``Dataset`` instances keyed by (dataset name,
    plan fingerprint). Entries hold no file handles of their own — they
    share the server's per-dataset ``DataSource`` — so eviction is free."""

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self._ent: "OrderedDict[tuple[str, str], _Prepared]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_or_prepare(self, name: str, source: DataSource,
                       plan: LogicalPlan) -> tuple[Dataset, str, bool]:
        """(prepared dataset, fingerprint, was_hit). On a miss the plan is
        optimized and lowered *here*, under no lock but before publication,
        so every later hit skips both (and never races on the instance's
        plan caches)."""
        fp = plan.fingerprint()
        key = (name, fp)
        with self._lock:
            ent = self._ent.get(key)
            if ent is not None:
                self._ent.move_to_end(key)
                ent.hits += 1
                self.hits += 1
                _metrics.counter("bullion.serve.plan_cache_hits").inc()
                return ent.ds, fp, True
        ds = Dataset(source, plan)
        ds.tasks()   # populate optimize/lower caches (footer-only, no I/O)
        with self._lock:
            ent = self._ent.get(key)
            if ent is not None:          # racing prepare: first one wins
                self._ent.move_to_end(key)
                ent.hits += 1
                self.hits += 1
                _metrics.counter("bullion.serve.plan_cache_hits").inc()
                return ent.ds, fp, True
            self._ent[key] = _Prepared(ds=ds, fingerprint=fp)
            self.misses += 1
            _metrics.counter("bullion.serve.plan_cache_misses").inc()
            while len(self._ent) > self.capacity:
                self._ent.popitem(last=False)
        return ds, fp, False

    def __len__(self) -> int:
        with self._lock:
            return len(self._ent)


class TenantBudget:
    """Counting budget of io_depth permits for one tenant.

    A query acquires ``min(requested, depth)`` permits for its whole
    execution, so the sum of in-flight io_depths — and with it the tenant's
    possible concurrent preads *and* concurrent object-store ranges (the
    held depth is also the scheduler's ``max_in_flight`` for batched remote
    fetches) — never exceeds ``depth``. Requests are clamped, never
    rejected: a single query asking for more than the budget runs at the
    budget, and one permit is always obtainable, so no query can deadlock
    itself."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"tenant io_depth budget must be >= 1, "
                             f"got {depth}")
        self.depth = int(depth)
        self._avail = int(depth)
        self._cond = threading.Condition()
        self.peak_in_flight = 0      # max permits ever held at once
        self.waits = 0               # acquisitions that had to block

    def acquire(self, want: int) -> int:
        want = max(1, min(int(want), self.depth))
        with self._cond:
            if self._avail < want:
                self.waits += 1
            while self._avail < want:
                self._cond.wait()
            self._avail -= want
            self.peak_in_flight = max(self.peak_in_flight,
                                      self.depth - self._avail)
        return want

    def release(self, n: int) -> None:
        with self._cond:
            self._avail += n
            self._cond.notify_all()


class DatasetServer:
    """Serve select/where/head plans over attached Bullion datasets.

    In-process: ``server.query("ads", where=C("id") == 7)``. Over a local
    socket: ``server.serve(path)`` + ``ServeClient(path)``. Both funnel
    into the same bounded executor pool. ``device`` (default ``cuda``;
    raises where CUDA is absent) is where every query's range filter and
    dequantize run."""

    def __init__(self, datasets: Optional[dict[str, PathSpec]] = None, *,
                 max_workers: int = 4, plan_cache_size: int = 64,
                 tenant_io_depth: int = 8, default_io_depth: int = 2,
                 query_log: Optional[_querylog.QueryLog] = None,
                 query_log_size: int = 256, device=None):
        self.device = resolve_device(device)
        self._sources: dict[str, DataSource] = {}
        # the flight recorder: every query/submit appends one record (env
        # knobs BULLION_QUERY_LOG / BULLION_SLOW_MS are read here)
        self.query_log = _querylog.QueryLog(query_log_size) \
            if query_log is None else query_log
        self._cache = PlanCache(plan_cache_size)
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="bullion-serve")
        self.max_workers = int(max_workers)
        self.default_io_depth = int(default_io_depth)
        self.tenant_io_depth = int(tenant_io_depth)
        self._tenants: dict[str, TenantBudget] = {}
        self._lock = threading.Lock()
        self._pending = 0            # submitted, not yet finished
        self._queries = 0
        self._errors = 0
        self._closed = False
        # socket front-end state
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: list[threading.Thread] = []
        self.socket_path: Optional[str] = None
        for name, spec in (datasets or {}).items():
            self.attach(name, spec)

    # -- datasets ---------------------------------------------------------------
    def attach(self, name: str, spec: PathSpec) -> None:
        """Register a dataset — local paths or ``bullion://bucket/key``
        object-store URIs (or a mixed list). Shard footers are parsed at
        most once here (via the process-wide footer cache; remote entries
        validate by ETag/length) and shared by every session. Remote
        shards' concurrent in-flight ranges stay bounded by the same
        per-tenant io_depth budgets that bound local preads."""
        if name in self._sources:
            raise ValueError(f"dataset {name!r} already attached")
        self._sources[name] = DataSource(discover(spec))

    def datasets(self) -> list[str]:
        return sorted(self._sources)

    def _source(self, name: str) -> DataSource:
        try:
            return self._sources[name]
        except KeyError:
            raise KeyError(
                f"unknown dataset {name!r}; attached: "
                f"{sorted(self._sources)}") from None

    def tenant_budget(self, tenant: str, depth: Optional[int] = None
                      ) -> TenantBudget:
        """Get (or create) a tenant's budget; ``depth`` sets the budget on
        first use (later calls ignore it — budgets are fixed at creation)."""
        with self._lock:
            b = self._tenants.get(tenant)
            if b is None:
                b = self._tenants[tenant] = TenantBudget(
                    self.tenant_io_depth if depth is None else depth)
            return b

    # -- planning ---------------------------------------------------------------
    def _build_plan(self, columns: Optional[Sequence[str]],
                    where: Optional[Predicate],
                    head: Optional[int]) -> LogicalPlan:
        return LogicalPlan(
            columns=tuple(columns) if columns is not None else None,
            predicate=where, limit=head, device=self.device)

    def prepare(self, dataset: str, *,
                columns: Optional[Sequence[str]] = None,
                where: Optional[Predicate] = None,
                head: Optional[int] = None) -> tuple[Dataset, str, bool]:
        """Resolve (and cache) the prepared plan for a query shape without
        executing it. Returns (dataset instance, fingerprint, cache hit)."""
        source = self._source(dataset)
        plan = self._build_plan(columns, where, head)
        return self._cache.get_or_prepare(dataset, source, plan)

    def explain(self, dataset: str, *,
                columns: Optional[Sequence[str]] = None,
                where: Optional[Predicate] = None,
                head: Optional[int] = None) -> str:
        ds, fp, hit = self.prepare(dataset, columns=columns, where=where,
                                   head=head)
        return (f"Prepared[{dataset} {fp[:12]} "
                f"{'hit' if hit else 'miss'}]\n" + ds.explain())

    # -- querying ---------------------------------------------------------------
    def submit(self, dataset: str, *,
               columns: Optional[Sequence[str]] = None,
               where: Optional[Predicate] = None,
               head: Optional[int] = None,
               tenant: str = DEFAULT_TENANT,
               io_depth: Optional[int] = None,
               trace_id: Optional[str] = None,
               collect_spans: bool = False) -> "Future[QueryResult]":
        """Queue a query on the bounded pool and return its Future.
        Admission control happens here: the pool caps concurrent
        executions, and the submit-time queue depth is recorded.
        ``trace_id`` tags the query's spans and its query-log record;
        ``collect_spans=True`` additionally runs the query under a scoped
        tracer and returns the finished spans on the result (what the wire
        front-end uses for client-side ``profile()``)."""
        if self._closed:
            raise RuntimeError("server is closed")
        with self._lock:
            self._pending += 1
            depth = self._pending
        _metrics.histogram("bullion.serve.queue_depth").observe(depth)
        fut = self._pool.submit(self._run, dataset, columns, where, head,
                                tenant, io_depth, trace_id, collect_spans)
        fut.add_done_callback(self._done)
        return fut

    def query(self, dataset: str, *,
              columns: Optional[Sequence[str]] = None,
              where: Optional[Predicate] = None,
              head: Optional[int] = None,
              tenant: str = DEFAULT_TENANT,
              io_depth: Optional[int] = None,
              timeout: Optional[float] = None,
              trace_id: Optional[str] = None,
              collect_spans: bool = False) -> QueryResult:
        """Blocking query: submit + wait."""
        return self.submit(dataset, columns=columns, where=where, head=head,
                           tenant=tenant, io_depth=io_depth,
                           trace_id=trace_id,
                           collect_spans=collect_spans).result(timeout)

    def _done(self, fut: Future) -> None:
        with self._lock:
            self._pending -= 1
            if fut.exception() is not None:
                self._errors += 1

    def _record(self, rec: _querylog.QueryRecord) -> None:
        try:
            self.query_log.append(rec)
        except Exception:        # telemetry must never fail a query
            pass

    def _run(self, dataset: str, columns, where, head, tenant: str,
             io_depth: Optional[int], trace_id: Optional[str] = None,
             collect_spans: bool = False) -> QueryResult:
        t0 = time.perf_counter()
        rec = _querylog.QueryRecord(
            ts=time.time(), origin="serve", dataset=dataset, tenant=tenant,
            columns=list(columns) if columns is not None else None,
            predicate=repr(where) if where is not None else None,
            trace_id=trace_id)
        # the scoped tracer costs span allocations, so it runs only when a
        # caller asked for spans, a slow-query threshold is armed, or a
        # process-wide recording is already on — the default serve hot path
        # stays span-allocation-free (asserted in tests)
        want_spans = (collect_spans or _trace.enabled()
                      or self.query_log.slow_seconds is not None)
        scope = tracer = None
        held = 0
        budget = None
        try:
            ds, fp, hit = self.prepare(dataset, columns=columns, where=where,
                                       head=head)
            rec.fingerprint, rec.cache_hit = fp, hit
            source = self._sources[dataset]
            budget = self.tenant_budget(tenant)
            want = self.default_io_depth if io_depth is None else io_depth
            held = budget.acquire(want)
            if want_spans:
                scope = _trace.collect()
                tracer = scope.__enter__()
            try:
                before = source.stats
                sp = _trace.span("serve.query", cat="serve", dataset=dataset,
                                 tenant=tenant, cache_hit=hit)
                if trace_id is not None and sp.enabled:
                    sp.set(trace_id=trace_id)
                with sp:
                    table = ds.to_table(io_depth=held)
                # exact for this query while queries on the dataset don't
                # overlap (the source accounting is dataset-wide)
                rec.io = dataclasses.asdict(source.stats.delta(before))
                rec.degraded = bool(rec.io.get("degraded_rows"))
            finally:
                if scope is not None:
                    scope.__exit__(None, None, None)
            rec.rows = _table_rows(table)
            rec.result_bytes = executor.table_nbytes(table)
            rec.wall_seconds = wall = time.perf_counter() - t0
            spans_out = None
            if tracer is not None:
                rec.stages = _querylog.stage_dict(tracer.aggregate())
                rec.dropped_spans = tracer.dropped
                slow = (self.query_log.slow_seconds is not None
                        and wall >= self.query_log.slow_seconds)
                if collect_spans or slow:
                    spans_out = [_trace.span_to_dict(s, wall=True)
                                 for s in tracer.spans]
                if slow:
                    rec.spans = spans_out
            self._record(rec)
            with self._lock:
                self._queries += 1
            _metrics.counter("bullion.serve.queries").inc()
            _metrics.histogram("bullion.serve.wall_seconds").observe(wall)
            return QueryResult(table=table, rows=rec.rows, cache_hit=hit,
                               fingerprint=fp, wall_seconds=wall,
                               tenant=tenant, trace_id=trace_id,
                               spans=spans_out if collect_spans else None,
                               degraded=rec.degraded,
                               degraded_rows=int(
                                   (rec.io or {}).get("degraded_rows") or 0))
        except Exception as e:
            rec.outcome = "error"
            rec.error = f"{type(e).__name__}: {e}"
            rec.wall_seconds = time.perf_counter() - t0
            self._record(rec)
            e.__bullion_logged__ = True   # _session won't double-record
            raise
        finally:
            if held and budget is not None:
                budget.release(held)

    # -- introspection ----------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            tenants = {name: {"io_depth": b.depth,
                              "peak_in_flight": b.peak_in_flight,
                              "waits": b.waits}
                       for name, b in self._tenants.items()}
            queries, errors, pending = \
                self._queries, self._errors, self._pending
        tr = _trace.current()
        return {
            "queries": queries,
            "errors": errors,
            "pending": pending,
            "max_workers": self.max_workers,
            "plan_cache": {"hits": self._cache.hits,
                           "misses": self._cache.misses,
                           "size": len(self._cache),
                           "capacity": self._cache.capacity},
            "tenants": tenants,
            "datasets": {
                name: {"shards": src.n_shards, "rows": src.num_rows,
                       "io": dataclasses.asdict(src.stats)}
                for name, src in self._sources.items()},
            # a truncated recording must be visible, not look complete
            "trace": {"installed": tr is not None,
                      "spans": len(tr.spans) if tr is not None else 0,
                      "dropped": tr.dropped if tr is not None else 0},
            "query_log": self.query_log.summary(),
            # decode-time verification posture + every quarantined page
            # (path -> [(group, page, reason)]), so operators see exactly
            # which shards need repair and degraded queries are explicable
            "integrity": {
                "verify_policy": _integrity.verify_policy(),
                "on_corrupt": _integrity.corruption_policy(),
                **_integrity.QUARANTINE.summary(),
            },
        }

    def metrics_text(self) -> str:
        """The process metrics registry rendered as Prometheus text
        exposition format (also served by the ``metrics`` wire command)."""
        return prometheus_text()

    # -- socket front-end -------------------------------------------------------
    def serve(self, socket_path: Optional[str] = None) -> str:
        """Start the AF_UNIX listener (thread-per-session) and return the
        socket path. Sessions submit into the same bounded pool as the
        in-process API, so admission control is shared."""
        if self._listener is not None:
            raise RuntimeError(f"already serving on {self.socket_path}")
        if socket_path is None:
            socket_path = os.path.join(
                tempfile.mkdtemp(prefix="bullion-serve-"), "serve.sock")
        self.socket_path = socket_path
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(socket_path)
        self._listener.listen()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="bullion-serve-accept",
            daemon=True)
        self._accept_thread.start()
        return socket_path

    def _accept_loop(self) -> None:
        # the loop keeps its own reference: close() sets self._listener to
        # None, which the reference's loop can read before accept() fails
        listener = self._listener
        while True:
            try:
                conn, _ = listener.accept()
            except OSError:
                return                   # listener closed
            t = threading.Thread(target=self._session, args=(conn,),
                                 name="bullion-serve-session", daemon=True)
            t.start()
            self._conn_threads.append(t)

    def _wire_error(self, error: str, op=None, dataset=None) -> None:
        """Record a protocol-level failure (malformed/oversized frame,
        unknown command, bad request) in the query log: broken clients are
        production events too."""
        self._record(_querylog.QueryRecord(
            ts=time.time(), origin="serve.wire",
            dataset=str(dataset) if dataset is not None else "",
            outcome="error", error=error,
            predicate=f"op={op!r}" if op is not None else None))

    def _session(self, conn: socket.socket) -> None:
        with conn:
            while True:
                try:
                    req = wire.recv_msg(conn)
                except (ConnectionError, ValueError) as e:
                    # torn or oversized frame: drop this session (the frame
                    # boundary is lost), leave a record, server lives on
                    self._wire_error(f"{type(e).__name__}: {e}")
                    return
                except OSError:
                    return
                if req is None:
                    return
                try:
                    resp = self._dispatch(req)
                except Exception as e:   # per-request fault isolation
                    if not getattr(e, "__bullion_logged__", False):
                        self._wire_error(f"{type(e).__name__}: {e}",
                                         op=req.get("op"),
                                         dataset=req.get("dataset"))
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                try:
                    wire.send_msg(conn, resp)
                except OSError:
                    return

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "pong": True}
        if op == "stats":
            return {"ok": True, "stats": self.stats()}
        if op == "datasets":
            return {"ok": True, "datasets": self.datasets()}
        if op == "metrics":
            return {"ok": True, "text": self.metrics_text()}
        if op == "log":
            return {"ok": True,
                    "records": [r.to_dict() for r in
                                self.query_log.tail(req.get("n", 50))]}
        if op == "explain":
            return {"ok": True, "explain": self.explain(
                req["dataset"], columns=req.get("columns"),
                where=wire.decode_predicate(req.get("where")),
                head=req.get("head"))}
        if op == "query":
            trace_req = req.get("trace") or {}
            trace_id = trace_req.get("id")
            res = self.query(
                req["dataset"], columns=req.get("columns"),
                where=wire.decode_predicate(req.get("where")),
                head=req.get("head"),
                tenant=req.get("tenant", DEFAULT_TENANT),
                io_depth=req.get("io_depth"),
                trace_id=trace_id, collect_spans=bool(trace_req))
            resp = {"ok": True, "rows": res.rows,
                    "cache_hit": res.cache_hit,
                    "fingerprint": res.fingerprint,
                    "wall_seconds": res.wall_seconds,
                    "degraded": res.degraded,
                    "degraded_rows": res.degraded_rows,
                    "table": wire.encode_table(res.table)}
            if trace_req:
                resp["trace"] = {"id": trace_id,
                                 "spans": res.spans or []}
            return resp
        self._wire_error(f"unknown op {op!r}", op=op,
                         dataset=req.get("dataset"))
        return {"ok": False, "error": f"unknown op {op!r}"}

    # -- lifecycle --------------------------------------------------------------
    def close(self) -> None:
        """Stop accepting, drain the pool, close shard readers. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._listener is not None:
            try:
                # close() alone leaves the accept thread blocked until its
                # join timeout; shutdown() wakes accept() immediately
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            finally:
                self._listener = None
            if self._accept_thread is not None:
                self._accept_thread.join(timeout=5)
            if self.socket_path and os.path.exists(self.socket_path):
                try:
                    os.unlink(self.socket_path)
                except OSError:
                    pass
        self._pool.shutdown(wait=True)
        for src in self._sources.values():
            src.close()
        self.query_log.close()

    def __enter__(self) -> "DatasetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
