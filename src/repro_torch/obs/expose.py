"""Metrics exposition: registry snapshot -> Prometheus text format.

Renders the process-wide ``MetricsRegistry`` in the Prometheus text
exposition format (version 0.0.4): counters as ``counter`` metrics,
log-scale histograms as ``summary`` metrics carrying the p50/p99 quantile
estimates plus ``_sum``/``_count`` — exactly what the registry's
``snapshot()`` already computes, no extra locking or bucket walks on the
hot path. Dotted metric names (``bullion.io.preads``) become underscored
(``bullion_io_preads``) per Prometheus naming rules.

The reference package serves it through its dataset server and CLI
(``bullion metrics``), which are not ported yet; scraping it from a sidecar
is one HTTP handler away.
"""

from __future__ import annotations

import re
from typing import Optional

from . import metrics as _metrics

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Prometheus metric name: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = _NAME_RE.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def prometheus_text(snapshot: Optional[dict] = None) -> str:
    """Render a registry snapshot (default: the process registry) as
    Prometheus text exposition format. Deterministic order (snapshot is
    name-sorted); ends with a newline as the format requires."""
    snap = _metrics.snapshot() if snapshot is None else snapshot
    lines: list[str] = []
    for name, v in snap.items():
        pname = sanitize_name(name)
        if isinstance(v, dict):
            # histogram snapshot -> summary metric with quantile estimates
            lines.append(f"# TYPE {pname} summary")
            lines.append(f'{pname}{{quantile="0.5"}} {_fmt(v.get("p50"))}')
            lines.append(f'{pname}{{quantile="0.99"}} {_fmt(v.get("p99"))}')
            lines.append(f"{pname}_sum {_fmt(v.get('sum', 0.0))}")
            lines.append(f"{pname}_count {_fmt(v.get('count', 0))}")
        else:
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {_fmt(v)}")
    return "\n".join(lines) + "\n" if lines else ""


# one line of the text format: HELP/TYPE comment, or `name{labels} value`
_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"                       # metric name
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""            # optional label set
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?"
    r" [^ ]+$")                                        # value


def parse_prometheus_text(text: str) -> dict[str, float]:
    """Strict parse of the exposition format back into {sample: value}
    (labels kept verbatim in the key). Raises ``ValueError`` on any line
    that is neither a comment nor a well-formed sample — the regression
    test for ``metrics_text()`` round-trips through this."""
    out: dict[str, float] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        if not _SAMPLE_RE.match(line):
            raise ValueError(f"line {ln}: not Prometheus text format: "
                             f"{line!r}")
        key, val = line.rsplit(" ", 1)
        out[key] = float(val)
    return out
