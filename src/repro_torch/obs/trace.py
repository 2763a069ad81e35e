"""Span tracing: the observability core (stdlib-only, no repro imports).

One process-wide tracer slot drives every instrumentation point in the
read/write stack (``plan.optimize``/``lower``, ``Scanner.plan``, the
``IOScheduler``, ``decode_group``'s stages, the sink, the loader). The
contract the hot paths rely on:

* **disabled is free** — with no tracer installed, ``span()`` returns one
  shared no-op context manager and allocates no ``Span`` object at all.
  ``allocations()`` counts every real span ever created, so tests assert
  the disabled hot path stays span-allocation-free; the bench_io wide
  probe gates the wall-clock overhead (< 2%).
* **enabled is thread-safe** — finished spans append to the tracer's list
  under a lock; spans started on scheduler/loader/pool threads record on
  whatever thread finishes them (the span holds its own tracer reference,
  so uninstalling mid-span is safe).
* **scopes nest** — ``collect()`` installs a fresh tracer for its block and
  *forwards* every finished span to the tracer it shadowed, so a scoped
  ``explain(analyze=True)`` or ``Dataset.profile()`` never hides events
  from a process-wide ``BULLION_TRACE`` recording.
* **``BULLION_TRACE=path``** enables a process-wide tracer when
  ``repro_torch.obs`` first loads and writes a Chrome ``trace_event`` JSON
  (loadable in Perfetto / chrome://tracing) at interpreter exit.
  ``BULLION_TRACE_CAP`` bounds the buffer (default 200k spans; overflow is
  counted, never an error).
"""

from __future__ import annotations

import atexit
import functools
import os
import sys
import threading
import time
from typing import Callable, Optional

# all trace timestamps are seconds relative to this module's load instant —
# a monotonic zero shared by every thread in the process. The wall-clock
# instant of the same zero lets two processes exchange spans on a shared
# (wall) timebase: rel -> wall is `ts + _EPOCH_WALL`, wall -> rel is
# `ts - _EPOCH_WALL` in the receiving process.
_EPOCH = time.perf_counter()
_EPOCH_WALL = time.time()

_DEFAULT_CAP = 200_000


def _default_cap() -> int:
    env = os.environ.get("BULLION_TRACE_CAP")
    if env is None or not env.strip():
        return _DEFAULT_CAP
    try:
        cap = int(env)
    except ValueError:
        raise ValueError(
            f"BULLION_TRACE_CAP must be an integer span count, "
            f"got {env!r}") from None
    if cap <= 0:
        raise ValueError(f"BULLION_TRACE_CAP must be positive, got {cap}")
    return cap


class SpanRecord:
    """One finished span: what the exporters and aggregators consume."""

    __slots__ = ("name", "cat", "ts", "dur", "tid", "tname", "args")

    def __init__(self, name: str, cat: str, ts: float, dur: float,
                 tid: int, tname: str, args: dict):
        self.name = name
        self.cat = cat
        self.ts = ts            # seconds since _EPOCH
        self.dur = dur          # seconds
        self.tid = tid
        self.tname = tname
        self.args = args

    def __repr__(self) -> str:
        return (f"SpanRecord({self.name!r}, dur={self.dur * 1e3:.3f}ms, "
                f"args={self.args})")


def _arg_safe(v):
    """JSON-able coercion for span args (numpy scalars included) without
    importing numpy — same contract as the exporter's coercion."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    for cast in (int, float):
        try:
            c = cast(v)
        except (TypeError, ValueError):
            continue
        if c == v:
            return c
    return str(v)


def span_to_dict(rec: SpanRecord, *, wall: bool = False) -> dict:
    """JSON-able dict form of a finished span (the wire / query-log
    representation). ``wall=True`` converts the timestamp to wall-clock
    epoch seconds so a peer process can rebase it into its own timebase."""
    return {"name": rec.name, "cat": rec.cat,
            "ts": rec.ts + _EPOCH_WALL if wall else rec.ts,
            "dur": rec.dur, "tid": rec.tid, "tname": rec.tname,
            "args": {k: _arg_safe(v) for k, v in rec.args.items()}}


def span_from_dict(d: dict, *, wall: bool = False) -> SpanRecord:
    """Inverse of ``span_to_dict``; with ``wall=True`` the incoming
    timestamp is wall-clock and is rebased to this process's epoch."""
    ts = float(d["ts"])
    if wall:
        ts -= _EPOCH_WALL
    return SpanRecord(d["name"], d.get("cat", "bullion"), ts,
                      float(d["dur"]), int(d.get("tid", 0)),
                      d.get("tname", ""), dict(d.get("args") or {}))


class _NullSpan:
    """The shared disabled-mode span: enter/exit/set are no-ops. One
    instance serves every call site (re-entrant: it holds no state)."""

    __slots__ = ()
    enabled = False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **kw) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()

# every real Span ever constructed bumps this (the disabled-mode
# zero-allocation assertion reads it before/after a scan)
_allocations = 0
_alloc_lock = threading.Lock()


def allocations() -> int:
    """Total real ``Span`` objects created since process start."""
    return _allocations


class Span:
    """A live span: context manager recording wall time on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")
    enabled = True

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        global _allocations
        with _alloc_lock:
            _allocations += 1
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0

    def set(self, **kw) -> "Span":
        """Attach attributes mid-span (guard expensive computation with
        ``if sp.enabled:`` — the null span's class attribute is False)."""
        self.args.update(kw)
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        th = threading.current_thread()
        self._tracer._record(SpanRecord(
            self.name, self.cat, self._t0 - _EPOCH, t1 - self._t0,
            th.ident or 0, th.name, self.args))
        return False


class StageAgg:
    """Aggregated view of one span name: call count, total seconds, and the
    numeric args summed across calls (bytes, pages, rows, ...)."""

    __slots__ = ("count", "seconds", "args")

    def __init__(self):
        self.count = 0
        self.seconds = 0.0
        self.args: dict = {}

    def __repr__(self) -> str:
        return (f"StageAgg(count={self.count}, "
                f"seconds={self.seconds:.6f}, args={self.args})")


class Tracer:
    """Thread-safe span collector with a bounded buffer.

    ``forward`` chains finished spans to an enclosing tracer (how nested
    ``collect()`` scopes coexist with a process-wide ``BULLION_TRACE``
    recording without stealing its events).
    """

    def __init__(self, *, max_spans: Optional[int] = None,
                 forward: Optional["Tracer"] = None):
        self.max_spans = _default_cap() if max_spans is None else int(max_spans)
        self.spans: list[SpanRecord] = []
        self.dropped = 0
        self._forward = forward
        self._lock = threading.Lock()

    def span(self, name: str, cat: str = "bullion",
             args: Optional[dict] = None) -> Span:
        return Span(self, name, cat, {} if args is None else args)

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self.spans) < self.max_spans:
                self.spans.append(rec)
            else:
                self.dropped += 1
        if self._forward is not None:
            self._forward._record(rec)

    def aggregate(self) -> dict[str, StageAgg]:
        """Per-name totals (thread-safe snapshot): count, summed seconds,
        summed numeric args. Parallel stages can sum past wall clock —
        the totals are CPU-side time across threads."""
        with self._lock:
            spans = list(self.spans)
        return aggregate_spans(spans)


def aggregate_spans(spans) -> dict[str, StageAgg]:
    """Per-name totals over any span sequence (list or ``Tracer.spans``
    snapshot): count, summed seconds, summed numeric args."""
    out: dict[str, StageAgg] = {}
    for s in spans:
        agg = out.get(s.name)
        if agg is None:
            agg = out[s.name] = StageAgg()
        agg.count += 1
        agg.seconds += s.dur
        for k, v in s.args.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            agg.args[k] = agg.args.get(k, 0) + v
    return out


# ---------------------------------------------------------------------------
# the process-wide tracer slot
# ---------------------------------------------------------------------------

_tracer: Optional[Tracer] = None


def enabled() -> bool:
    """Is any tracer installed? (One global read — safe on hot paths.)"""
    return _tracer is not None


def current() -> Optional[Tracer]:
    return _tracer


def install(tracer: Optional[Tracer]) -> None:
    """Set (or, with None, clear) the process-wide tracer."""
    global _tracer
    _tracer = tracer


def enable(*, max_spans: Optional[int] = None) -> Tracer:
    """Install and return a fresh process-wide tracer."""
    t = Tracer(max_spans=max_spans)
    install(t)
    return t


def disable() -> Optional[Tracer]:
    """Uninstall the tracer (span() reverts to the free no-op path).
    Returns the tracer that was installed, spans intact."""
    t = _tracer
    install(None)
    return t


def span(name: str, cat: str = "bullion", **args):
    """Start a span on the installed tracer — the one call every
    instrumentation point uses. Disabled: returns the shared no-op span
    (no Span allocation; the kwargs dict is the only cost)."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return t.span(name, cat, args)


class collect:
    """``with collect() as tr:`` — scoped tracing. Installs a fresh tracer
    for the block (forwarding to whatever it shadowed) and restores the
    previous tracer on exit; ``tr.spans`` holds the block's spans."""

    def __init__(self, *, max_spans: Optional[int] = None):
        self._max_spans = max_spans
        self._prev: Optional[Tracer] = None
        self.tracer: Optional[Tracer] = None

    def __enter__(self) -> Tracer:
        self._prev = _tracer
        self.tracer = Tracer(max_spans=self._max_spans, forward=self._prev)
        install(self.tracer)
        return self.tracer

    def __exit__(self, *exc) -> bool:
        install(self._prev)
        return False


def traced(name: Optional[str] = None, cat: str = "bullion") -> Callable:
    """Decorator form: ``@traced()`` wraps the function body in a span named
    after it (or ``name``). Disabled mode calls the function directly."""
    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            t = _tracer
            if t is None:
                return fn(*a, **kw)
            with t.span(label, cat):
                return fn(*a, **kw)
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# BULLION_TRACE: process-wide recording -> Chrome trace JSON at exit
# ---------------------------------------------------------------------------

_env_tracer: Optional[Tracer] = None
_env_path: Optional[str] = None


def _write_env_trace() -> None:
    if _env_tracer is None or _env_path is None:
        return
    from .export import write_trace
    try:
        write_trace(_env_path, _env_tracer.spans,
                    dropped=_env_tracer.dropped)
    except Exception as e:  # never fail interpreter shutdown
        print(f"bullion: BULLION_TRACE export to {_env_path!r} failed: {e}",
              file=sys.stderr)


def init_from_env() -> Optional[Tracer]:
    """Honor ``BULLION_TRACE=path``: enable a process-wide tracer and
    register the exit-time Chrome trace export. Idempotent; called when
    ``repro_torch.obs`` first imports."""
    global _env_tracer, _env_path
    path = os.environ.get("BULLION_TRACE")
    if not path or not path.strip() or _env_tracer is not None:
        return _env_tracer
    _env_path = path.strip()
    _env_tracer = enable()
    atexit.register(_write_env_trace)
    return _env_tracer
