"""Statistics-driven pruning scanner: the planning half of the scan path.

``Scanner.plan`` intersects a predicate with the file's zone maps at two
granularities. Chunk zone maps (``Sec.CHUNK_STATS``) prune whole row groups
that provably contain no matching row; inside surviving groups, per-page
zone maps (``Sec.PAGE_STATS``) prune individual page ordinals — every
column of a group splits at the same row boundaries, so one refuted ordinal
drops one page per read column (``ScanPlan.group_page_sel``). All pruning
happens before any data pread, and the plan accounts the pages and bytes it
avoided. On stat-less (v0) files every group survives and the scan degrades
to a plain filtered read; single-page files simply never page-prune.

Execution — decode, deletion-masking, dequantization, predicate filtering,
payload gathering — lives in ``repro_torch.dataset.executor.execute_group``, the
single pipeline shared with the lazy ``Dataset`` API; ``Scanner.scan`` is a
thin per-group loop over it kept for direct (single-file, eager) use.

Row ids are reported in the file's *raw* row space (deletion vectors do not
renumber rows), which is what ``core.deletion`` consumes for predicate-based
deletes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Iterator, Optional, Sequence

import numpy as np

from ..core.footer import Sec
from ..obs import trace as _trace
from .predicate import Predicate

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from ..core.reader import BullionReader


@dataclass
class ScanPlan:
    """Result of zone-map pruning, before any data I/O."""

    groups: list[int]                     # surviving row groups, in scan order
    pruned_groups: list[int]              # provably-empty row groups
    groups_pruned_sketch: int = 0         # of those, refuted by value sketch
    pages_pruned: int = 0                 # page reads avoided by pruning
    pages_total: int = 0                  # page reads a full scan would issue
    bytes_pruned: int = 0                 # data bytes those pages hold
    bytes_total: int = 0
    group_pages: dict = field(default_factory=dict)   # group -> page count
    group_bytes: dict = field(default_factory=dict)   # group -> data bytes
    # group -> surviving page ordinals, only for groups where page zone maps
    # pruned a strict subset (absent = read every page of the chunk)
    group_page_sel: dict = field(default_factory=dict)
    # group -> (pages, bytes) already credited to pages/bytes_pruned by
    # page-granular pruning — a later pass dropping the whole group must
    # charge only the remainder, not the full group cost again
    group_avoided: dict = field(default_factory=dict)

    def remaining_cost(self, group: int) -> tuple[int, int]:
        """(pages, bytes) of ``group`` not yet counted as pruned."""
        pages, nbytes = self.group_avoided.get(group, (0, 0))
        return (self.group_pages.get(group, 0) - pages,
                self.group_bytes.get(group, 0) - nbytes)

    @property
    def selectivity_bound(self) -> float:
        total = len(self.groups) + len(self.pruned_groups)
        return len(self.groups) / total if total else 1.0


@dataclass
class ScanBatch:
    """Matching rows of one row group."""

    group: int
    row_ids: np.ndarray                   # global ids, raw row space
    table: dict = field(default_factory=dict)


def _group_stats(fv, group: int, cols: Sequence[str]) -> dict:
    """Map column name -> chunk STAT record (or None on v0 files)."""
    chunk = fv.chunk_stats()
    if chunk is None:
        return {name: None for name in cols}
    n_cols = fv.n_cols
    return {name: chunk[group * n_cols + fv.column_index(name)]
            for name in cols}


def _group_sketches(fv, group: int, cols: Sequence[str]) -> dict:
    """Column name -> chunk BloomSketch, for columns that have one."""
    out = {}
    for name in cols:
        sk = fv.chunk_sketch(group, fv.column_index(name))
        if sk is not None:
            out[name] = sk
    return out


def _pages_for(fv, group: int, cols: Sequence[str]) -> list[int]:
    out: list[int] = []
    for name in cols:
        s, e = fv.chunk_pages(group, fv.column_index(name))
        out.extend(range(s, e))
    return out


def _page_prune(fv, group: int, pred: Predicate, pred_cols: Sequence[str],
                read_cols: Sequence[str], page_size: np.ndarray
                ) -> tuple[Optional[tuple[int, ...]], int, int]:
    """Page-granular refinement inside a group the chunk zone maps kept.

    Every column of a group splits at the same row boundaries (the writer's
    page_rows budget), so page ordinal k is one row range across all read
    columns: an ordinal whose per-page stats refute the predicate drops one
    page *per read column*. Returns (surviving ordinals or None for all,
    pages avoided, bytes avoided); degrades to None (no page pruning) on
    stat-less files, single-page chunks, or — defensively — chunks whose
    page row boundaries disagree."""
    page_stats = fv.page_stats()
    if page_stats is None:
        return None, 0, 0
    page_rows = fv.arr(Sec.PAGE_ROWS, np.uint32)
    starts: dict[str, int] = {}
    # column 0 anchors the executor's ordinal -> raw-row-range mapping
    # (``selected_raw_rows``/``group_keep``), so its boundaries must agree
    # with every read column before any ordinal may be dropped
    s0, e0 = fv.chunk_pages(group, 0)
    first_rows: np.ndarray = page_rows[s0:e0]
    for name in read_cols:
        s, e = fv.chunk_pages(group, fv.column_index(name))
        starts[name] = s
        if not np.array_equal(page_rows[s:e], first_rows):
            return None, 0, 0
    n_ord = len(first_rows)
    if n_ord <= 1:
        return None, 0, 0
    surviving: list[int] = []
    pages_avoided = bytes_avoided = 0
    page_sketches = fv.has(Sec.PAGE_SKETCH)
    for k in range(n_ord):
        stats = {name: page_stats[starts[name] + k] for name in pred_cols}
        keep = pred.maybe_any(stats)
        if keep and page_sketches:
            sks = {}
            for name in pred_cols:
                sk = fv.page_sketch(starts[name] + k)
                if sk is not None:
                    sks[name] = sk
            if sks and pred.sketch_refutes(sks):
                keep = False
        if keep:
            surviving.append(k)
        else:
            pages_avoided += len(read_cols)
            bytes_avoided += int(sum(int(page_size[starts[name] + k])
                                     for name in read_cols))
    if len(surviving) == n_ord:
        return None, 0, 0
    return tuple(surviving), pages_avoided, bytes_avoided


def plan_scan(fv, pred: Optional[Predicate], columns: Sequence[str] = (),
              groups: Optional[Sequence[int]] = None) -> ScanPlan:
    """Footer-only zone-map planning (needs no open file handle):
    intersect ``pred`` with the chunk zone maps — and, inside surviving
    groups, with the per-page zone maps — and account the page/byte cost of
    every candidate group. ``pred=None`` prunes nothing."""
    sp = _trace.span("scan.plan", cat="plan")
    with sp:
        plan = _plan_scan(fv, pred, columns, groups)
        if sp.enabled:
            sp.set(groups_kept=len(plan.groups),
                   groups_pruned=len(plan.pruned_groups),
                   groups_pruned_sketch=plan.groups_pruned_sketch,
                   pages_pruned=plan.pages_pruned,
                   bytes_pruned=plan.bytes_pruned)
    return plan


def _plan_scan(fv, pred: Optional[Predicate], columns: Sequence[str] = (),
               groups: Optional[Sequence[int]] = None) -> ScanPlan:
    pred_cols = sorted(pred.columns()) if pred is not None else []
    read_cols = list(dict.fromkeys([*pred_cols, *columns]))
    candidates = list(groups) if groups is not None \
        else list(range(fv.n_groups))
    page_size = fv.arr(Sec.PAGE_SIZE, np.uint64)
    plan = ScanPlan(groups=[], pruned_groups=[])
    for g in candidates:
        pages = _pages_for(fv, g, read_cols)
        nbytes = int(sum(int(page_size[p]) for p in pages))
        plan.pages_total += len(pages)
        plan.bytes_total += nbytes
        plan.group_pages[g] = len(pages)
        plan.group_bytes[g] = nbytes
        if pred is not None and \
                not pred.maybe_any(_group_stats(fv, g, pred_cols)):
            plan.pruned_groups.append(g)
            plan.pages_pruned += len(pages)
            plan.bytes_pruned += nbytes
            continue
        if pred is not None and fv.has_sketches and \
                pred.sketch_refutes(_group_sketches(fv, g, pred_cols)):
            # the zone maps admitted the group (unclustered columns always
            # do), but the bloom sketch proves the probed value absent
            plan.pruned_groups.append(g)
            plan.groups_pruned_sketch += 1
            plan.pages_pruned += len(pages)
            plan.bytes_pruned += nbytes
            continue
        sel = None
        if pred is not None:
            sel, pages_avoided, bytes_avoided = \
                _page_prune(fv, g, pred, pred_cols, read_cols, page_size)
            if sel is not None and not sel:
                # per-page maps are tighter than their chunk union: every
                # ordinal refuted -> the whole group is provably empty
                plan.pruned_groups.append(g)
                plan.pages_pruned += len(pages)
                plan.bytes_pruned += nbytes
                continue
            if sel is not None:
                plan.group_page_sel[g] = sel
                plan.group_avoided[g] = (pages_avoided, bytes_avoided)
                plan.pages_pruned += pages_avoided
                plan.bytes_pruned += bytes_avoided
        plan.groups.append(g)
    return plan


class Scanner:
    def __init__(self, reader: "BullionReader"):
        self.reader = reader
        self.fv = reader.footer

    def __enter__(self) -> "Scanner":
        return self

    def __exit__(self, *exc) -> None:
        # The scanner context owns the reader's handle: exiting closes it
        # (idempotent), so ``with Scanner(BullionReader(p)) as s:`` cannot
        # leak on an aborted scan. Don't enter a scanner context when the
        # reader must outlive it — close() is shared with the reader.
        self.reader.close()

    # -- planning ---------------------------------------------------------------
    def plan(self, pred: Optional[Predicate], columns: Sequence[str] = (),
             groups: Optional[Sequence[int]] = None) -> ScanPlan:
        """Zone-map pruning: decide which row groups can possibly match.
        ``pred=None`` plans an unpruned scan (all candidates survive) but
        still accounts per-group page/byte costs for downstream planning."""
        return plan_scan(self.fv, pred, columns, groups)

    # -- scanning ---------------------------------------------------------------
    def scan(self, pred: Predicate, columns: Sequence[str] = (),
             groups: Optional[Sequence[int]] = None, *,
             drop_deleted: bool = True, dequant: bool = True,
             use_kernel: Optional[bool] = None,
             device=None) -> Iterator[ScanBatch]:
        """Yield matching rows per surviving group. ``device`` is where the
        range filter runs (default ``cuda``).

        ``columns`` are the payload columns materialized in each batch (the
        predicate's own columns are always available and included when
        requested). Payload pages are only read for groups where at least one
        row survived the filter — the second half of the I/O win.
        """
        from .. import resolve_device
        from ..dataset.executor import execute_group
        from ..dataset.plan import group_bounds

        device = resolve_device(device)
        plan = self.plan(pred, columns, groups)
        self.reader.stats.bytes_pruned += plan.bytes_pruned
        self.reader.stats.pages_pruned += plan.pages_pruned
        self.reader.stats.groups_pruned_sketch += plan.groups_pruned_sketch
        bounds = group_bounds(self.fv)
        for g in plan.groups:
            res = execute_group(self.reader, g, columns=columns,
                                predicate=pred, drop_deleted=drop_deleted,
                                dequant=dequant, use_kernel=use_kernel,
                                pages=plan.group_page_sel.get(g),
                                device=device)
            if res is None:
                continue
            yield ScanBatch(group=g, row_ids=bounds[g] + res.row_ids,
                            table=res.table)

    def find_rows(self, pred: Predicate, *, drop_deleted: bool = False,
                  use_kernel: Optional[bool] = None,
                  device=None) -> np.ndarray:
        """Global row ids (raw row space) whose rows satisfy ``pred``."""
        parts = [b.row_ids for b in self.scan(pred, drop_deleted=drop_deleted,
                                              use_kernel=use_kernel,
                                              device=device)]
        return np.concatenate(parts) if parts \
            else np.zeros(0, np.int64)
