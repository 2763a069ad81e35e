"""Observability substrate: span tracing, metrics, Perfetto trace export.

The shared instrumentation layer under the whole scan/I-O/decode pipeline
(and the substrate the serve/cloud-backend roadmap items report through).
Three pieces, all stdlib-only with no repro imports (any layer — ``core``
included — may depend on it without cycles):

* ``trace`` — a ``Span`` tracer with context-manager/decorator API and a
  process-wide slot. Disabled (the default) it is a no-op that allocates
  nothing on the hot path; ``collect()`` scopes a tracer to a block
  (forwarding to any enclosing recording), ``BULLION_TRACE=path`` records
  process-wide and exports Chrome trace JSON at exit.
* ``metrics`` — a process-wide ``MetricsRegistry`` of named counters and
  log-scale histograms (pread latency, coalesced-run sizes, queue depth,
  per-encoding-family page decode time). Counters absorb ``IOStats`` when
  reader accounting retires; timing histograms follow ``trace.enabled()``.
* ``export`` — Chrome ``trace_event`` rendering (``chrome_trace`` /
  ``write_trace``) viewable in Perfetto, plus the ``Profile`` object
  ``Dataset.profile()`` returns.
* ``querylog`` — thread-safe bounded ``QueryLog`` of structured per-query
  records (tenant, fingerprint, stage timings, exact ``IOStats`` delta,
  outcome), fed by the serve path and — under ``BULLION_QUERY_LOG=path``
  (JSONL sink) — by local ``Dataset`` terminals; ``BULLION_SLOW_MS``
  promotes slow queries' full span lists into their records.
* ``expose`` — the registry snapshot rendered as Prometheus text format
  (what the dataset server's ``metrics`` command serves; the server is not
  ported yet).

Entry points most callers want::

    from repro_torch.obs import trace, metrics

    with trace.collect() as tr:          # scoped tracing
        ...                              # any Dataset/loader/sink work
    print(tr.aggregate())                # per-stage totals
    print(metrics.snapshot())            # process-wide counters/histograms
"""

from . import expose, metrics, querylog, trace
from .export import Profile, chrome_trace, write_trace
from .expose import parse_prometheus_text, prometheus_text
from .metrics import (Counter, Histogram, MetricsRegistry, REGISTRY,
                      absorb_iostats, counter, histogram, snapshot)
from .querylog import QueryLog, QueryRecord
from .trace import (NULL_SPAN, Span, SpanRecord, StageAgg, Tracer,
                    aggregate_spans, collect, disable, enable, enabled,
                    install, span, span_from_dict, span_to_dict, traced)

# honor BULLION_TRACE=path as soon as the first instrumented module loads
trace.init_from_env()

__all__ = [
    "trace", "metrics", "querylog", "expose",
    "Span", "SpanRecord", "StageAgg", "Tracer", "NULL_SPAN",
    "span", "collect", "traced", "enable", "disable", "enabled", "install",
    "span_to_dict", "span_from_dict", "aggregate_spans",
    "Counter", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "histogram", "snapshot", "absorb_iostats",
    "QueryLog", "QueryRecord",
    "prometheus_text", "parse_prometheus_text",
    "Profile", "chrome_trace", "write_trace",
]
