"""Process-wide metrics: named counters and log-scale histograms.

The registry is the always-on half of the observability layer (spans are
the opt-in half): counters are one lock + one add, histograms bucket on a
power-of-two scale via ``math.frexp`` so a latency or size distribution
costs O(60) ints however many observations land in it. The conventions the
instrumented stack follows:

* **counters are always cheap enough to leave on** — preads, bytes,
  cache hits absorbed in bulk from ``IOStats`` at reader-retire time
  (``absorb_iostats``), run sizes observed once per coalesced submission;
* **timing histograms record only while tracing is enabled** — wrapping
  every ``os.pread`` in two ``perf_counter`` calls is not free, so the
  per-call latency distributions (``bullion.io.pread_seconds``, per-family
  page decode time) follow ``trace.enabled()``; with tracing off the hot
  path pays one global read.

Names are dotted lowercase (``bullion.io.pread_seconds``); the per-family
decode histograms append the ``PageType`` name
(``bullion.decode.page_seconds.scalar``). ``snapshot()`` renders the whole
registry as plain dicts for printing or shipping.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional, Union

Number = Union[int, float]


class Counter:
    """Monotonic named counter (float-tolerant: second-counters absorb
    ``IOStats.metadata_seconds`` too)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v: Number = 0
        self._lock = threading.Lock()

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> Number:
        return self._v

    def __repr__(self) -> str:
        return f"Counter({self.name!r}, {self._v})"


class Histogram:
    """Log-scale (power-of-two) histogram.

    ``observe(v)`` lands ``v`` in the bucket whose upper bound is the
    smallest power of two >= v (``frexp`` exponent), so one histogram
    covers nanoseconds to hours / bytes to gigabytes with ~60 buckets and
    no configuration. Zero and negatives fall into a dedicated underflow
    bucket (upper bound 0).
    """

    __slots__ = ("name", "count", "sum", "min", "max", "_buckets", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[Number] = None
        self.max: Optional[Number] = None
        self._buckets: dict[Optional[int], int] = {}   # exponent -> count
        self._lock = threading.Lock()

    @staticmethod
    def _bucket(v: Number) -> Optional[int]:
        if v <= 0:
            return None                       # underflow bucket
        m, e = math.frexp(v)                  # v = m * 2**e, 0.5 <= m < 1
        return e                              # upper bound 2**e >= v

    def observe(self, v: Number) -> None:
        b = self._bucket(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._buckets[b] = self._buckets.get(b, 0) + 1

    def percentile(self, p: float) -> float:
        """Upper-bound estimate of the p-th percentile (0 < p <= 100):
        the upper edge of the bucket holding that rank."""
        with self._lock:
            if not self.count:
                return 0.0
            rank = max(1, math.ceil(self.count * p / 100.0))
            items = sorted(((e if e is not None else -10**6), n)
                           for e, n in self._buckets.items())
        seen = 0
        for e, n in items:
            seen += n
            if seen >= rank:
                return 0.0 if e == -10**6 else float(2.0 ** e)
        return float(2.0 ** items[-1][0])

    def buckets(self) -> dict[float, int]:
        """{upper_bound: count} with 0.0 for the underflow bucket."""
        with self._lock:
            return {(0.0 if e is None else float(2.0 ** e)): n
                    for e, n in sorted(self._buckets.items(),
                                       key=lambda kv: (-1 if kv[0] is None
                                                       else kv[0]))}

    def __repr__(self) -> str:
        return (f"Histogram({self.name!r}, count={self.count}, "
                f"sum={self.sum:.6g}, min={self.min}, max={self.max})")


class MetricsRegistry:
    """Named counters + histograms, get-or-create, thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram(name))
        return h

    def snapshot(self) -> dict:
        """Plain-dict view of everything: counters as numbers, histograms
        as {count, sum, min, max, p50, p99, buckets}."""
        with self._lock:
            counters = dict(self._counters)
            hists = dict(self._hists)
        out: dict = {}
        for name, c in sorted(counters.items()):
            out[name] = c.value
        for name, h in sorted(hists.items()):
            out[name] = {"count": h.count, "sum": h.sum,
                         "min": h.min, "max": h.max,
                         "p50": h.percentile(50), "p99": h.percentile(99),
                         "buckets": h.buckets()}
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()


# the process-wide registry every instrumentation point reports through
REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def absorb_iostats(stats, *, prefix: str = "bullion.io.",
                   registry: Optional[MetricsRegistry] = None) -> None:
    """Fold one ``IOStats`` (any dataclass of numeric fields) into the
    registry's counters, one counter per field. Called when a reader's
    accounting retires (``DataSource``), so the registry supersedes ad-hoc
    cross-dataset aggregation without touching the per-scan hot path."""
    reg = REGISTRY if registry is None else registry
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if v:
            reg.counter(prefix + f.name).inc(v)
