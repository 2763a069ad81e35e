"""Write-time page/chunk statistics (zone maps).

Each page and each (row-group, column) chunk carries one fixed-size record:
min/max over the values a reader would decode, a null (NaN) count, and a
distinct-value estimate. min/max are stored as float64 *outer bounds*: the
recorded min is always <= the true minimum and the recorded max >= the true
maximum, even for int64/uint64 values that float64 cannot represent exactly —
pruning decisions stay sound, they just lose at most one ULP of selectivity.

Records describe the *logical* value domain (post quantize->dequantize for
quantized columns), i.e. exactly what ``BullionReader`` hands back with
``dequant=True``, so predicate evaluation and zone-map pruning agree. The
distinct estimate is exact per page (pages are bounded by the writer's
``page_rows`` budget; the chunk-level merge is an upper bound, not a union
cardinality) and doubles as the input signal for the stats-driven encoding
advisor, which now scores every page independently.
"""

from __future__ import annotations

import numpy as np

STAT_DTYPE = np.dtype([
    ("min", "<f8"),
    ("max", "<f8"),
    ("null_count", "<u8"),
    ("distinct", "<u8"),
    ("flags", "<u8"),
])

HAS_MINMAX = 1       # min/max fields are valid
LIST_ELEMENTS = 2    # stats describe ragged-list *elements*, not rows


def f8_lower(v) -> float:
    """Largest float64 known to be <= v (exact for floats and small ints)."""
    f = np.float64(v)
    if np.isfinite(f) and isinstance(v, (int, np.integer)) and int(f) > int(v):
        f = np.nextafter(f, -np.inf)
    return float(f)


def f8_upper(v) -> float:
    """Smallest float64 known to be >= v."""
    f = np.float64(v)
    if np.isfinite(f) and isinstance(v, (int, np.integer)) and int(f) < int(v):
        f = np.nextafter(f, np.inf)
    return float(f)


def f8_exact(v) -> bool:
    """True when float64(v) == v exactly (no rounding)."""
    f = np.float64(v)
    if not np.isfinite(f):
        return True
    if isinstance(v, (int, np.integer)):
        return int(f) == int(v)
    return True


def empty_record() -> np.ndarray:
    return np.zeros((), STAT_DTYPE)


def stats_record(values, *, is_list: bool = False) -> np.ndarray:
    """Compute one STAT_DTYPE record for a decoded page/chunk.

    ``values``: np.ndarray for scalar pages, list[np.ndarray] for list pages
    (rows are flattened to elements), list[bytes] for string pages (no
    min/max, distinct only).
    """
    rec = empty_record()
    if isinstance(values, list):
        if values and isinstance(values[0], (bytes, bytearray, memoryview)):
            rec["distinct"] = len({bytes(s) for s in values})
            return rec
        values = (np.concatenate([np.asarray(v).ravel() for v in values])
                  if values else np.zeros(0))
        is_list = True
    arr = np.asarray(values).ravel()
    if is_list:
        rec["flags"] = np.uint64(rec["flags"]) | LIST_ELEMENTS
    if arr.size == 0 or arr.dtype.kind not in "iufb":
        return rec
    if arr.dtype.kind == "f":
        nulls = int(np.isnan(arr).sum())
        rec["null_count"] = nulls
        finite = arr[~np.isnan(arr)] if nulls else arr
    else:
        finite = arr
    rec["distinct"] = len(np.unique(arr)) if arr.dtype.kind != "f" \
        else len(np.unique(finite)) + (1 if int(rec["null_count"]) else 0)
    if finite.size == 0:
        return rec  # all-NaN page: no usable min/max
    if arr.dtype.kind in "iub":
        lo, hi = int(finite.min()), int(finite.max())
    else:
        lo, hi = float(finite.min()), float(finite.max())
    rec["min"] = f8_lower(lo)
    rec["max"] = f8_upper(hi)
    rec["flags"] = np.uint64(rec["flags"]) | HAS_MINMAX
    return rec


def merge_records(records) -> np.ndarray:
    """Fold page records into one chunk record (union of zone maps)."""
    out = empty_record()
    recs = [np.asarray(r) for r in records]
    if not recs:
        return out
    with_mm = [r for r in recs if int(r["flags"]) & HAS_MINMAX]
    if with_mm:
        out["min"] = min(float(r["min"]) for r in with_mm)
        out["max"] = max(float(r["max"]) for r in with_mm)
        out["flags"] = np.uint64(out["flags"]) | HAS_MINMAX
    if any(int(r["flags"]) & LIST_ELEMENTS for r in recs):
        out["flags"] = np.uint64(out["flags"]) | LIST_ELEMENTS
    out["null_count"] = sum(int(r["null_count"]) for r in recs)
    # upper bound, not a union cardinality — good enough for an estimate
    out["distinct"] = sum(int(r["distinct"]) for r in recs)
    return out


def widen_to_zero(rec: np.ndarray) -> None:
    """Extend a record's range to include 0 in place.

    Physical deletion (§2.1 L2) masks rows to zeros without re-reading the
    survivors, so the stored zone map must be widened rather than recomputed.
    """
    if int(rec["flags"]) & HAS_MINMAX:
        rec["min"] = min(float(rec["min"]), 0.0)
        rec["max"] = max(float(rec["max"]), 0.0)
