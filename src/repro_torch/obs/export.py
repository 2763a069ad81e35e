"""Chrome ``trace_event`` export: spans -> Perfetto-loadable JSON.

The JSON object format (``{"traceEvents": [...]}``) with complete events
(``"ph": "X"``, microsecond ``ts``/``dur``) is what Perfetto and
chrome://tracing both load directly; nesting is inferred from timestamp
containment per thread, so the tracer needs no explicit parent ids.
Thread-name metadata events give the scheduler / loader / scan-pool
threads readable track names.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

from .trace import SpanRecord, Tracer


def _json_safe(v):
    """Span args may carry numpy scalars; coerce without importing numpy
    (obs stays dependency-free)."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    for cast in (int, float):
        try:
            c = cast(v)
        except (TypeError, ValueError):
            continue
        if c == v:          # int() must not truncate a fractional scalar
            return c
    return str(v)


def chrome_trace(spans: Sequence[SpanRecord], *, pid: Optional[int] = None,
                 dropped: int = 0, trace_id: Optional[str] = None) -> dict:
    """Render finished spans as a Chrome trace_event JSON object.
    ``trace_id`` stamps the wire-propagated id on the document (the
    merged client+server profile carries exactly one)."""
    pid = os.getpid() if pid is None else pid
    events: list[dict] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": "bullion"},
    }]
    named: set[int] = set()
    for s in spans:
        if s.tid not in named:
            named.add(s.tid)
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": s.tid,
                           "args": {"name": s.tname}})
        events.append({
            "ph": "X", "name": s.name, "cat": s.cat,
            "ts": round(s.ts * 1e6, 3), "dur": round(s.dur * 1e6, 3),
            "pid": pid, "tid": s.tid,
            "args": {k: _json_safe(v) for k, v in s.args.items()},
        })
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if dropped:
        out["bullionDroppedSpans"] = int(dropped)
    if trace_id is not None:
        out["bullionTraceId"] = trace_id
    return out


def write_trace(path: str, spans: Sequence[SpanRecord], *,
                dropped: int = 0, trace_id: Optional[str] = None) -> str:
    """Write ``spans`` as one Chrome trace JSON file; returns ``path``."""
    doc = chrome_trace(spans, dropped=dropped, trace_id=trace_id)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)   # a killed export never leaves a torn JSON
    return path


class Profile:
    """What ``Dataset.profile()`` returns: the collected spans plus the
    rendered Chrome trace, with a one-call file export."""

    def __init__(self, tracer: Optional[Tracer] = None, *,
                 spans: Optional[Sequence[SpanRecord]] = None,
                 dropped: int = 0, trace_id: Optional[str] = None):
        self.spans = list(tracer.spans if tracer is not None
                          else (spans or []))
        self.dropped = (tracer.dropped if tracer is not None else 0) + dropped
        self.trace_id = trace_id

    @classmethod
    def from_spans(cls, spans: Sequence[SpanRecord], *, dropped: int = 0,
                   trace_id: Optional[str] = None) -> "Profile":
        """Build a profile from a bare span list (e.g. client + server
        spans merged after wire propagation)."""
        return cls(spans=spans, dropped=dropped, trace_id=trace_id)

    @property
    def chrome(self) -> dict:
        return chrome_trace(self.spans, dropped=self.dropped,
                            trace_id=self.trace_id)

    def aggregate(self):
        from .trace import aggregate_spans
        return aggregate_spans(self.spans)

    def write(self, path: str) -> str:
        return write_trace(path, self.spans, dropped=self.dropped,
                           trace_id=self.trace_id)

    def __repr__(self) -> str:
        return f"Profile({len(self.spans)} span(s), dropped={self.dropped})"
