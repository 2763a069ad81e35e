"""Statistics-driven scan subsystem: zone maps, predicate pushdown, pruning.

Design -> paper mapping (Bullion: A Column Store for Machine Learning):

* **§2.3 wide-table projection** — projection already touches only the
  requested columns' pages; this package adds the orthogonal axis: touching
  only the *row groups and pages* a predicate can match. ``scanner.Scanner``
  intersects predicates with per-chunk zone maps before any data pread.
* **§2.1 deletion compliance** — ``core.deletion.delete_where`` locates
  victim rows through the pruning scanner, so compliance deletes (e.g.
  "erase user X") read only the groups whose statistics admit the victim
  instead of decoding the whole column.
* **§2.5 quality-aware organization** — write-path quality presorting makes
  quality zone maps monotone across groups, so threshold reads
  (``BullionLoader(predicate=C("quality") >= t)``) prune to a prefix of the
  file; the statistics are collected by ``BullionWriter`` at write time
  (``scan.stats``).
* **§2.6 cascading encoding selection** — the same per-chunk min/max/
  distinct records are the input signal for a future LEA-style learned
  encoding advisor (see ROADMAP open items).

Layout:

  stats.py      — STAT_DTYPE records, write-time collection helpers
                  (persisted in ``Sec.PAGE_STATS`` / ``Sec.CHUNK_STATS``,
                  format v1; v0 files read fine and simply never prune)
  predicate.py  — predicate AST (Cmp/In/And/Or/Not), ``C`` builder,
                  vectorized NumPy evaluator, sound three-valued zone-map
                  tests, and compilation to conjunctive ranges
  scanner.py    — ScanPlan/Scanner: group pruning with page/byte accounting;
                  execution delegates to the unified ``repro_torch.dataset``
                  pipeline (two-phase predicate-then-payload reads, the
                  range-filter kernel) — see ``repro_torch.dataset.executor``
  sketch.py     — per-chunk/per-page bloom value sketches (format v3,
                  ``Sec.CHUNK_SKETCH``): metadata-resident refutation of
                  equality probes on *unclustered* columns, where zone maps
                  are useless
"""

from .predicate import (And, C, Cmp, In, Not, Or, Predicate, canonical_repr,
                        conjunctive_ranges, evaluate)
from .scanner import ScanBatch, ScanPlan, Scanner, plan_scan
from .sketch import BloomSketch, canonical_u64
from .stats import (HAS_MINMAX, LIST_ELEMENTS, STAT_DTYPE, merge_records,
                    stats_record)

__all__ = [
    "And", "C", "Cmp", "In", "Not", "Or", "Predicate", "canonical_repr",
    "conjunctive_ranges", "evaluate", "ScanBatch", "ScanPlan", "Scanner",
    "plan_scan", "BloomSketch", "canonical_u64", "HAS_MINMAX",
    "LIST_ELEMENTS", "STAT_DTYPE", "merge_records", "stats_record",
]
