"""Logical and physical scan plans.

A chained ``Dataset`` records *what* the caller wants in a ``LogicalPlan``
(pure data, no I/O). ``optimize`` normalizes it — conjunct splitting,
projection narrowing to predicate+output columns, validation against the
dataset schema. ``lower`` turns the optimized plan into a ``PhysicalPlan``:
one ``ScanTask`` per (shard, row group) that could contain a matching row —
carrying the group's surviving page ordinals when page-granular zone maps
pruned inside it — with every avoided group *and page* accounted as pruned
bytes (zone maps, row-id location, or a ``head`` limit each prove reads
unnecessary before any data pread).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np

from ..obs import trace as _trace
from ..scan.predicate import And, Predicate

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from .source import DataSource


@dataclass(frozen=True)
class LogicalPlan:
    """Declarative description of one scan. Immutable; chaining replaces."""

    columns: Optional[tuple[str, ...]] = None   # None = all columns
    predicate: Optional[Predicate] = None
    row_ids: Optional[np.ndarray] = None        # global ids, raw row space
    groups: Optional[tuple[int, ...]] = None    # legacy single-shard restriction
    dequantize: bool = True
    drop_deleted: bool = True
    limit: Optional[int] = None                 # head(n)
    use_kernel: Optional[bool] = None           # dequant + filter kernels: None = auto
    device: Optional[object] = None             # where they run (torch.device)

    def replace(self, **kw) -> "LogicalPlan":
        return replace(self, **kw)

    def fingerprint(self) -> str:
        """Stable content hash for prepared-plan caching.

        Two plans that request the same scan get the same fingerprint even
        when built differently: predicate conjunct/disjunct order is
        normalized through ``canonical_repr``, so ``.where(a).where(b)``
        and ``.where(b).where(a)`` collide (on purpose). Pinned row ids
        hash by content. The hash is *not* persisted anywhere, so the
        scheme may change freely between versions."""
        import hashlib

        from ..scan.predicate import canonical_repr
        bits = [
            "cols=" + ("*" if self.columns is None
                       else ",".join(self.columns)),
            "pred=" + canonical_repr(self.predicate),
            "groups=" + ("-" if self.groups is None
                         else ",".join(map(str, self.groups))),
            f"dequant={self.dequantize}",
            f"drop_deleted={self.drop_deleted}",
            f"limit={self.limit}",
            f"kernel={self.use_kernel}",
            f"rows={self.row_ids is not None}",
        ]
        h = hashlib.sha256("\n".join(bits).encode())
        if self.row_ids is not None:
            h.update(np.ascontiguousarray(
                np.asarray(self.row_ids, np.int64)).tobytes())
        return h.hexdigest()


@dataclass(frozen=True)
class OptimizedPlan:
    """LogicalPlan after normalization, with derived read sets."""

    logical: LogicalPlan
    output_columns: tuple[str, ...]   # materialized in results, in order
    pred_columns: tuple[str, ...]     # referenced by the predicate
    read_columns: tuple[str, ...]     # projection narrowing: output ∪ predicate
    conjuncts: tuple[Predicate, ...]  # top-level AND split (empty = no pred)

    def prefetch_columns(self, output_columns: Optional[Sequence[str]] = None
                         ) -> tuple[str, ...]:
        """Columns whose pages the I/O scheduler may stage eagerly for every
        task. With a predicate, only the predicate columns are uncondi-
        tionally read — payload pages are fetched on demand so groups the
        filter empties still skip them (the serial path's second I/O win).
        Without one, every read column's pages are certain to be decoded."""
        if self.logical.predicate is not None:
            return self.pred_columns
        return self.output_columns if output_columns is None \
            else tuple(output_columns)


class ColumnNotFoundError(KeyError):
    """A plan references a column absent from the dataset schema. Raised at
    plan time (``optimize``), naming the column and the shard whose footer
    defined the schema — never as a decode-time ``KeyError``."""

    def __init__(self, missing, names, shard_path):
        self.missing = list(missing)
        self.shard_path = shard_path
        super().__init__(
            f"column(s) {self.missing} not in dataset schema "
            f"(checked shard {shard_path!r}; available: {list(names)})")

    def __str__(self) -> str:  # KeyError quotes its lone arg; keep prose
        return self.args[0]


@dataclass(frozen=True)
class ScanTask:
    """One unit of physical work: decode+filter one row group of one shard."""

    shard: int
    group: int
    rows: Optional[np.ndarray] = None  # raw-local row ids from with_rows
    # surviving page ordinals inside the group (page-granular zone-map
    # pruning); None = every page of each chunk
    pages: Optional[tuple[int, ...]] = None


@dataclass
class PhysicalPlan:
    tasks: list[ScanTask] = field(default_factory=list)
    groups_total: int = 0
    groups_pruned: int = 0            # zone-map + row-locate + limit pruning
    groups_pruned_sketch: int = 0     # of those, refuted by bloom sketches
    pages_total: int = 0
    pages_pruned: int = 0
    bytes_total: int = 0              # data bytes a naive full scan would read
    bytes_pruned: int = 0             # bytes the plan proved it never had to read

    @property
    def selectivity_bound(self) -> float:
        kept = self.groups_total - self.groups_pruned
        return kept / self.groups_total if self.groups_total else 1.0


def split_conjuncts(pred: Optional[Predicate]) -> tuple[Predicate, ...]:
    """Top-level AND split (the ``And`` constructor already flattens
    nested conjunctions, so one level of unpacking is complete)."""
    if pred is None:
        return ()
    if isinstance(pred, And):
        return tuple(pred.children)
    return (pred,)


def optimize(plan: LogicalPlan, source: "DataSource") -> OptimizedPlan:
    """Normalize and validate a logical plan against the dataset schema."""
    with _trace.span("plan.optimize", cat="plan"):
        return _optimize(plan, source)


def _optimize(plan: LogicalPlan, source: "DataSource") -> OptimizedPlan:
    names = source.column_names
    if plan.columns is None:
        output = tuple(names)
    else:
        output = tuple(dict.fromkeys(plan.columns))
        missing = [c for c in output if c not in source.column_set]
        if missing:
            raise ColumnNotFoundError(missing, names, source.schema_path)
    conjuncts = split_conjuncts(plan.predicate)
    pred_cols = tuple(sorted(plan.predicate.columns())) if plan.predicate \
        else ()
    missing = [c for c in pred_cols if c not in source.column_set]
    if missing:
        raise ColumnNotFoundError(missing, names, source.schema_path)
    if plan.limit is not None and plan.limit < 0:
        raise ValueError(f"head(n) needs n >= 0, got {plan.limit}")
    if plan.groups is not None and source.n_shards > 1:
        raise ValueError("groups= restriction is single-shard only; "
                         "use with_rows on multi-file datasets")
    # projection narrowing: the executor touches exactly these columns
    read = tuple(dict.fromkeys([*output, *pred_cols]))
    return OptimizedPlan(logical=plan, output_columns=output,
                         pred_columns=pred_cols, read_columns=read,
                         conjuncts=conjuncts)


def group_bounds(fv) -> np.ndarray:
    """Cumulative raw-row bounds per group: bounds[g] is group g's first
    global (shard-local) row id. The one copy of the row-space arithmetic
    every planner/executor shares."""
    from ..core.footer import Sec
    rpg = fv.arr(Sec.ROWS_PER_GROUP, np.uint32).astype(np.int64)
    return np.concatenate([[0], np.cumsum(rpg)])


def locate_rows(fv, local_rows: np.ndarray) -> dict[int, np.ndarray]:
    """Shard-local raw row ids -> {group: group-local rows} (footer-only)."""
    bounds = group_bounds(fv)
    local_rows = np.asarray(local_rows, np.int64)
    g = np.searchsorted(bounds, local_rows, side="right") - 1
    return {int(grp): local_rows[g == grp] - bounds[grp]
            for grp in np.unique(g)}


def lower(opt: OptimizedPlan, source: "DataSource") -> PhysicalPlan:
    """Lower to per-(shard, group) tasks.

    Per shard: restrict to located groups when ``with_rows`` pinned rows,
    intersect the predicate with the shard's zone maps (``plan_scan``),
    and — when no predicate gates the row count — cap a ``head`` limit to
    the shortest prefix of groups holding enough visible rows. Every group
    dropped at this stage is charged to ``bytes_pruned``. Lowering is
    footer-only: no shard file handle is opened until execution.
    """
    sp = _trace.span("plan.lower", cat="plan")
    with sp:
        phys = _lower(opt, source)
        if sp.enabled:
            sp.set(tasks=len(phys.tasks), shards=source.n_shards,
                   groups_pruned=phys.groups_pruned,
                   pages_pruned=phys.pages_pruned,
                   bytes_pruned=phys.bytes_pruned)
    return phys


def _lower(opt: OptimizedPlan, source: "DataSource") -> PhysicalPlan:
    from ..scan.scanner import plan_scan
    from .executor import group_keep, raw_row_count, visible_row_count

    plan = opt.logical
    phys = PhysicalPlan()
    remaining = plan.limit
    for s in range(source.n_shards):
        fv = source.footer(s)
        candidates = list(plan.groups) if plan.groups is not None \
            else list(range(fv.n_groups))
        located: Optional[dict[int, np.ndarray]] = None
        if plan.row_ids is not None:
            lo, hi = source.row_offset(s), source.row_offset(s + 1)
            ids = plan.row_ids[(plan.row_ids >= lo) & (plan.row_ids < hi)]
            located = locate_rows(fv, ids - lo) if len(ids) else {}
        scan_plan = plan_scan(fv, plan.predicate, columns=opt.read_columns,
                              groups=candidates)
        phys.groups_total += len(candidates)
        phys.pages_total += scan_plan.pages_total
        phys.bytes_total += scan_plan.bytes_total
        phys.groups_pruned += len(scan_plan.pruned_groups)
        phys.groups_pruned_sketch += scan_plan.groups_pruned_sketch
        phys.pages_pruned += scan_plan.pages_pruned
        phys.bytes_pruned += scan_plan.bytes_pruned
        groups = scan_plan.groups
        if located is not None:
            for g in groups:
                if g not in located:
                    phys.groups_pruned += 1
                    # charge only what page-granular pruning didn't already
                    pages_left, bytes_left = scan_plan.remaining_cost(g)
                    phys.pages_pruned += pages_left
                    phys.bytes_pruned += bytes_left
            groups = [g for g in groups if g in located]
        if remaining is not None and plan.predicate is None:
            # head(n) with no predicate: the row count per group is knowable
            # from metadata alone, so excess groups are provably unread.
            kept: list[int] = []
            for g in groups:
                if remaining <= 0:
                    phys.groups_pruned += 1
                    pages_left, bytes_left = scan_plan.remaining_cost(g)
                    phys.pages_pruned += pages_left
                    phys.bytes_pruned += bytes_left
                    continue
                kept.append(g)
                if located is not None:
                    if plan.drop_deleted:
                        # only pinned rows that survive deletion vectors
                        # count against the limit
                        keep = group_keep(fv, g)
                        remaining -= len(located[g]) if keep is None \
                            else int(keep[located[g]].sum())
                    else:
                        remaining -= len(located[g])
                elif plan.drop_deleted:
                    remaining -= visible_row_count(fv, g)
                else:
                    remaining -= raw_row_count(fv, g)
            groups = kept
        phys.tasks.extend(
            ScanTask(shard=s, group=g,
                     rows=located[g] if located is not None else None,
                     pages=scan_plan.group_page_sel.get(g))
            for g in groups)
    return phys
