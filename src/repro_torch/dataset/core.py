"""Lazy ``Dataset``: chainable logical plans over Bullion data.

``dataset(path_or_glob)`` opens one file, a directory of shards, a glob, or
an explicit path list. Chaining (`select`/`where`/`with_rows`/`head`/...)
only rewrites an immutable ``LogicalPlan``; no I/O happens until a terminal
(``to_table``/``to_batches``/``count_rows``/``row_ids``) optimizes, lowers,
and executes it. The same plan runs unchanged over single- and multi-file
datasets.

``dataset(path, device=...)`` names where the dequantize of BF16 and
affine-integer columns and the predicate's range filter run (default
``cuda``; it raises where CUDA is absent unless given ``"cpu"``). Results are
NumPy tables on the host either way.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

import numpy as np

from .. import resolve_device
from ..core.footer import ColKind, Sec
from ..core.reader import BullionReader, IOStats
from ..obs import querylog as _querylog
from ..obs import trace as _trace
from ..scan.predicate import Predicate
from . import executor
from .plan import LogicalPlan, OptimizedPlan, PhysicalPlan, ScanTask, \
    group_bounds as _group_bounds, lower, optimize
from .source import DataSource, PathSpec


def dataset(path_or_paths: PathSpec, *,
            coalesce_gap: Optional[int] = None, device=None) -> "Dataset":
    """Open a lazy Dataset over one Bullion file, a shard directory, a glob
    pattern, or an explicit list of shard paths. Shard footers come from the
    process-wide footer cache (repeated opens of unchanged files parse
    nothing). ``coalesce_gap`` overrides the readers' pread-coalescing hole
    budget in bytes (default: ``BULLION_COALESCE_GAP`` or 64 KiB).
    ``device`` is where the dequantize and the range filter run: ``cuda``
    when None (raises where CUDA is absent), or ``"cpu"`` for the plain
    versions."""
    from .source import discover
    dev = resolve_device(device)
    return Dataset(DataSource(discover(path_or_paths),
                              coalesce_gap=coalesce_gap),
                   LogicalPlan(device=dev))


@dataclass
class DatasetBatch:
    """One surviving row group's worth of results."""

    shard: int
    group: int
    row_ids: np.ndarray              # global ids, raw row space
    table: dict = field(default_factory=dict)


class Dataset:
    """A logical scan plan over one or more Bullion shards."""

    def __init__(self, source: DataSource,
                 plan: Optional[LogicalPlan] = None):
        self._source = source
        self._plan = plan or LogicalPlan()
        # caches: the logical plan and footers are immutable for this
        # instance, so optimize/lower run once however many terminals fire
        self._opt: Optional[OptimizedPlan] = None
        self._phys: Optional[PhysicalPlan] = None
        self._task_pages: Optional[dict] = None   # (shard, group) -> ordinals
        self._credited = False          # pruned bytes: one credit per plan

    @classmethod
    def from_reader(cls, reader: BullionReader,
                    device=None) -> "Dataset":
        """One-file dataset over an already-open reader (legacy shims).
        The caller keeps ownership of the reader. ``device`` as for
        ``dataset``."""
        return cls(DataSource.from_reader(reader),
                   LogicalPlan(device=resolve_device(device)))

    def _chain(self, **kw) -> "Dataset":
        return Dataset(self._source, self._plan.replace(**kw))

    # -- chainable transforms ---------------------------------------------------
    def select(self, columns: Sequence[str]) -> "Dataset":
        """Project to ``columns`` (projection narrowing prunes all others)."""
        return self._chain(columns=tuple(columns))

    def where(self, predicate: Predicate) -> "Dataset":
        """Filter rows; repeated calls AND together. Zone maps prune row
        groups the predicate provably cannot match before any data pread."""
        combined = predicate if self._plan.predicate is None \
            else self._plan.predicate & predicate
        return self._chain(predicate=combined)

    def with_rows(self, row_ids) -> "Dataset":
        """Restrict to global row ids (raw row space, as reported by
        ``row_ids()``/``find_rows``). Groups holding none of them are pruned."""
        ids = np.unique(np.asarray(row_ids, np.int64))
        return self._chain(row_ids=ids)

    def dequantized(self, flag: bool = True) -> "Dataset":
        """Materialize quantized columns in the logical (float) domain
        (default) or as raw stored values (``False``). Predicates always
        evaluate in the logical domain either way."""
        return self._chain(dequantize=flag)

    def drop_deleted(self, flag: bool = True) -> "Dataset":
        """Hide deletion-vector rows (default) or keep the raw row space
        (``False``; what compliance tooling audits)."""
        return self._chain(drop_deleted=flag)

    def head(self, n: int) -> "Dataset":
        """Limit to the first ``n`` rows in scan order. Without a predicate
        the limit is pushed into planning: groups past the prefix holding
        ``n`` rows are never read."""
        return self._chain(limit=n)

    def _with_groups(self, groups: Optional[Sequence[int]]) -> "Dataset":
        """Legacy single-shard row-group restriction (internal)."""
        if groups is None:
            return self
        return self._chain(groups=tuple(int(g) for g in groups))

    def _with_kernel(self, use_kernel: Optional[bool]) -> "Dataset":
        return self._chain(use_kernel=use_kernel)

    # -- metadata ---------------------------------------------------------------
    @property
    def column_names(self) -> list[str]:
        return list(self._source.column_names)

    @property
    def num_rows(self) -> int:
        """Raw rows across all shards (metadata only; ignores the plan)."""
        return self._source.num_rows

    @property
    def n_shards(self) -> int:
        return self._source.n_shards

    @property
    def stats(self) -> IOStats:
        """Aggregate I/O accounting across every shard reader."""
        return self._source.stats

    # -- planning ---------------------------------------------------------------
    def plan(self) -> OptimizedPlan:
        """Optimize the logical plan (no I/O beyond footers). Cached: the
        logical plan is immutable, so hot per-group paths (the training
        loader) don't re-validate on every call."""
        if self._opt is None:
            self._opt = optimize(self._plan, self._source)
        return self._opt

    def physical_plan(self) -> PhysicalPlan:
        """Optimize + lower: per-(shard, group) tasks with pruned-bytes
        accounting. Footer-only; no file handle is opened and no data page
        touched. Cached per instance."""
        if self._phys is None:
            self._phys = lower(self.plan(), self._source)
        return self._phys

    def tasks(self) -> list[ScanTask]:
        """The physical task list, crediting pruned bytes to ``stats`` (one
        planning pass = one scan's worth of avoided I/O)."""
        phys = self.physical_plan()
        self._credit(phys)
        return phys.tasks

    def explain(self, analyze: bool = False, *,
                parallelism: int = 1, io_depth: int = 1) -> str:
        """Human-readable logical + physical plan.

        ``analyze=True`` additionally *executes* the plan under a scoped
        tracer and appends what actually happened: wall time, rows out,
        per-stage call counts / summed time / summed attributes (pages,
        bytes, rows...), and a machine-parsable ``io:`` line holding the
        ``IOStats`` delta this execution charged (every field, so the
        rendering reconciles exactly with ``Dataset.stats``). Results are
        materialized and discarded; ``parallelism``/``io_depth`` shape the
        execution like any other terminal. Run it on a fresh instance to
        also see the ``plan.optimize``/``plan.lower`` spans (plans cache
        per instance)."""
        if not analyze:
            return self._explain_static()
        before = self._source.stats
        # install the collector before plan() so optimize/lower spans land
        # in the report on a fresh instance; forwarding keeps a concurrent
        # BULLION_TRACE recording complete
        with _trace.collect() as tracer:
            static = self._explain_static()
            t0 = time.perf_counter()
            tasks = rows = 0
            for _, res in self._execute(parallelism=parallelism,
                                        io_depth=io_depth):
                tasks += 1
                rows += len(res.row_ids)
            wall = time.perf_counter() - t0
        io = self._source.stats.delta(before)
        agg = tracer.aggregate()
        lines = [static, "Execution (analyze=True):",
                 f"  wall: {wall * 1e3:.3f} ms  tasks: {tasks}  "
                 f"rows out: {rows}",
                 f"  {'stage':<20}{'calls':>7}{'time':>13}  detail"]
        for name in sorted(agg, key=lambda n: -agg[n].seconds):
            a = agg[name]
            detail = " ".join(
                f"{k}={a.args[k]:.3f}" if isinstance(a.args[k], float)
                else f"{k}={a.args[k]}" for k in sorted(a.args))
            lines.append((f"  {name:<20}{a.count:>7}"
                          f"{a.seconds * 1e3:>10.3f} ms  {detail}").rstrip())
        bits = []
        for f in dataclasses.fields(io):
            v = getattr(io, f.name)
            bits.append(f"{f.name}={v:.6f}" if isinstance(v, float)
                        else f"{f.name}={v}")
        lines.append("  io: " + " ".join(bits))
        # a capped tracer silently truncates; say so instead of looking
        # complete
        lines.append(f"  spans: {len(tracer.spans)} recorded, "
                     f"{tracer.dropped} dropped")
        return "\n".join(lines)

    def _explain_static(self) -> str:
        opt = self.plan()
        phys = self.physical_plan()
        p = self._plan
        lines = [
            "LogicalPlan:",
            f"  select: {list(opt.output_columns)}",
            f"  where: {p.predicate!r} ({len(opt.conjuncts)} conjunct(s))"
            if p.predicate is not None else "  where: -",
            f"  rows: {len(p.row_ids)} pinned row id(s)"
            if p.row_ids is not None else "  rows: -",
            f"  dequantize: {p.dequantize}  drop_deleted: {p.drop_deleted}"
            f"  limit: {p.limit}",
            f"  read columns (narrowed): {list(opt.read_columns)}",
            f"PhysicalPlan: {self.n_shards} shard(s), {len(phys.tasks)} task(s)",
            f"  groups: {phys.groups_total - phys.groups_pruned}/"
            f"{phys.groups_total} kept ({phys.groups_pruned} pruned, "
            f"{phys.groups_pruned_sketch} by value sketch)",
            f"  pages: {phys.pages_total - phys.pages_pruned}/"
            f"{phys.pages_total} kept ({phys.pages_pruned} pruned, "
            f"{sum(1 for t in phys.tasks if t.pages is not None)} "
            "page-subset task(s))",
            f"  bytes: <= {phys.bytes_total - phys.bytes_pruned} read, "
            f"{phys.bytes_pruned} pruned of {phys.bytes_total} total",
        ]
        return "\n".join(lines)

    # -- execution --------------------------------------------------------------
    def _credit(self, phys: PhysicalPlan) -> None:
        # One credit per Dataset instance (= one planned scan), however many
        # terminals observe it — tasks() + read_group() streaming and a
        # plain to_table() both count the avoided I/O exactly once.
        if (phys.bytes_pruned or phys.pages_pruned
                or phys.groups_pruned_sketch) and not self._credited:
            self._credited = True
            self._source.credit_pruned(phys.bytes_pruned, phys.pages_pruned,
                                       phys.groups_pruned_sketch)

    def _execute(self, output_columns: Optional[Sequence[str]] = None,
                 parallelism: int = 1, io_depth: int = 1
                 ) -> Iterator[tuple[ScanTask, executor.GroupResult]]:
        """Run the plan (see ``_execute_impl``). When local query-log
        recording is on (``BULLION_QUERY_LOG=path`` or
        ``querylog.enable_local()``), the run is wrapped so one structured
        record — wall time, rows, exact ``IOStats`` delta, stage timings if
        a tracer is live — lands in ``querylog.LOG`` when the iterator
        finishes (or dies); the default leaves the hot path untouched."""
        inner = self._execute_impl(output_columns, parallelism, io_depth)
        if not _querylog.local_enabled():
            return inner
        return self._execute_logged(inner, io_depth)

    def _execute_logged(self, inner, io_depth: int
                        ) -> Iterator[tuple[ScanTask, executor.GroupResult]]:
        rec = _querylog.QueryRecord(
            ts=_querylog.now(), origin="local",
            dataset=self._source.paths[0], tenant="local",
            columns=list(self._plan.columns)
            if self._plan.columns is not None else None,
            predicate=repr(self._plan.predicate)
            if self._plan.predicate is not None else None)
        try:
            rec.fingerprint = self._plan.fingerprint()
        except Exception:
            pass
        t0 = time.perf_counter()
        before = self._source.stats
        scope = tracer = None
        if _trace.enabled():
            scope = _trace.collect()
            tracer = scope.__enter__()
        try:
            for task, res in inner:
                rec.rows += len(res.row_ids)
                rec.result_bytes += executor.table_nbytes(res.table)
                yield task, res
        except BaseException as e:
            if not isinstance(e, GeneratorExit):
                rec.outcome = "error"
                rec.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            if scope is not None:
                scope.__exit__(None, None, None)
            rec.wall_seconds = time.perf_counter() - t0
            rec.io = dataclasses.asdict(self._source.stats.delta(before))
            rec.degraded = bool(rec.io.get("degraded_rows"))
            if tracer is not None:
                rec.stages = _querylog.stage_dict(tracer.aggregate())
                rec.dropped_spans = tracer.dropped
                if (_querylog.LOG.slow_seconds is not None
                        and rec.wall_seconds >= _querylog.LOG.slow_seconds):
                    rec.spans = [_trace.span_to_dict(s, wall=True)
                                 for s in tracer.spans]
            _querylog.LOG.append(rec)

    def _execute_impl(self, output_columns: Optional[Sequence[str]] = None,
                      parallelism: int = 1, io_depth: int = 1
                      ) -> Iterator[tuple[ScanTask, executor.GroupResult]]:
        """Run the plan; ``output_columns`` overrides materialization for
        data-free terminals (row_ids/count) without spawning a new instance
        (caches and the pruned-bytes credit stay shared). ``parallelism > 1``
        decodes independent (shard, group) tasks on a bounded thread pool;
        ``io_depth > 1`` prefetches upcoming tasks' coalesced byte ranges on
        the I/O scheduler so preads overlap decode (``io_depth=1`` is the
        serial per-group read path). Results stream in task order either
        way, so the output is identical to a serial run."""
        opt = self.plan()
        phys = self.physical_plan()
        self._credit(phys)
        p = opt.logical
        cols = opt.output_columns if output_columns is None \
            else tuple(output_columns)
        filtered = p.predicate is not None or p.row_ids is not None

        if io_depth < 1:
            raise ValueError(f"io_depth must be >= 1, got {io_depth}")
        emitted, limit = 0, p.limit
        if limit is not None and limit <= 0:
            return
        sched = None
        prefetch_cols = opt.prefetch_columns(cols)
        if io_depth > 1 and len(phys.tasks) > 1 and prefetch_cols:
            from .io import IOScheduler
            sched = IOScheduler(self._source, phys.tasks,
                                columns=prefetch_cols, io_depth=io_depth)

        def run(item) -> Optional[executor.GroupResult]:
            i, task = item
            with _trace.span("exec.task", cat="exec",
                             shard=task.shard, group=task.group):
                reader = sched.reader_for(i) if sched is not None \
                    else self._source.reader(task.shard)
                return executor.execute_group(
                    reader, task.group,
                    columns=cols, predicate=p.predicate,
                    rows=task.rows, drop_deleted=p.drop_deleted,
                    dequant=p.dequantize, use_kernel=p.use_kernel,
                    pages=task.pages, device=p.device)

        for (_, task), res in executor.run_tasks(
                list(enumerate(phys.tasks)), run, parallelism, io=sched):
            if res is None or (filtered and not len(res.row_ids)):
                continue
            if limit is not None and emitted + len(res.row_ids) > limit:
                res = executor.truncate_result(res, limit - emitted)
            emitted += len(res.row_ids)
            yield task, res
            if limit is not None and emitted >= limit:
                break

    def _page_sel(self, shard: int, group: int) -> Optional[tuple]:
        """Surviving page ordinals the lowered plan picked for (shard,
        group), so per-group streaming (``read_group``) prunes pages exactly
        like batch execution. None = read every page."""
        if self._task_pages is None:
            self._task_pages = {(t.shard, t.group): t.pages
                                for t in self.physical_plan().tasks}
        return self._task_pages.get((shard, group))

    def read_group(self, group: int, shard: int = 0, *,
                   reader=None) -> Optional[dict]:
        """Execute the plan over one row group (loader-style streaming).
        Returns the table dict, or None when no row survives. Honors the
        plan's predicate, ``with_rows`` pinning, and page-granular pruning;
        ``head`` limits don't apply (per-group streaming has no cross-group
        cursor). ``reader`` overrides the shard reader — the training
        loader passes a ``PrefetchReader`` staged by its I/O scheduler."""
        from .plan import locate_rows
        opt = self.plan()
        p = opt.logical
        rows = None
        if p.row_ids is not None:
            lo, hi = self._source.row_offset(shard), \
                self._source.row_offset(shard + 1)
            ids = p.row_ids[(p.row_ids >= lo) & (p.row_ids < hi)]
            rows = locate_rows(self._source.footer(shard),
                               ids - lo).get(group) if len(ids) else None
            if rows is None:
                return None
        res = executor.execute_group(
            self._source.reader(shard) if reader is None else reader,
            group, columns=opt.output_columns,
            predicate=p.predicate, rows=rows, drop_deleted=p.drop_deleted,
            dequant=p.dequantize, use_kernel=p.use_kernel,
            pages=self._page_sel(shard, group), device=p.device)
        return None if res is None else res.table

    # -- terminals --------------------------------------------------------------
    def scan_batches(self, *, parallelism: int = 1,
                     io_depth: int = 1) -> Iterator[DatasetBatch]:
        """Stream per-group results *with* their global row ids — the
        single-pass terminal when a caller needs both the data and the row
        identity (one scan, one pruned-bytes credit). ``parallelism > 1``
        decodes groups on a thread pool; ``io_depth > 1`` overlaps upcoming
        groups' preads with decode; the stream order is unchanged."""
        bounds: dict[int, np.ndarray] = {}
        for task, res in self._execute(parallelism=parallelism,
                                       io_depth=io_depth):
            if task.shard not in bounds:
                bounds[task.shard] = \
                    _group_bounds(self._source.footer(task.shard))
            offset = self._source.row_offset(task.shard) + \
                bounds[task.shard][task.group]
            yield DatasetBatch(shard=task.shard, group=task.group,
                               row_ids=offset + res.row_ids, table=res.table)

    def to_batches(self, batch_size: Optional[int] = None, *,
                   parallelism: int = 1, io_depth: int = 1) -> Iterator[dict]:
        """Stream result tables. ``batch_size=None`` yields one table per
        surviving row group (natural batches); an integer re-slices the
        stream into tables of exactly ``batch_size`` rows (last may be
        short)."""
        if batch_size is None:
            for _, res in self._execute(parallelism=parallelism,
                                        io_depth=io_depth):
                yield res.table
            return
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        cols = self.plan().output_columns
        buf: list[dict] = []
        buffered = 0
        for _, res in self._execute(parallelism=parallelism,
                                    io_depth=io_depth):
            buf.append(res.table)
            buffered += len(res.row_ids)
            while buffered >= batch_size:
                merged = _concat_tables(buf, cols)
                yield {k: v[:batch_size] for k, v in merged.items()}
                rest = {k: v[batch_size:] for k, v in merged.items()}
                buf, buffered = [rest], buffered - batch_size
        if buffered:
            yield _concat_tables(buf, cols)

    def to_table(self, *, parallelism: int = 1, io_depth: int = 1) -> dict:
        """Materialize the whole result as one column dict."""
        cols = self.plan().output_columns
        return _concat_tables(
            [res.table for _, res in self._execute(parallelism=parallelism,
                                                   io_depth=io_depth)],
            cols, empty=self._empty_column)

    def row_ids(self, *, parallelism: int = 1,
                io_depth: int = 1) -> np.ndarray:
        """Global row ids (raw row space) of every surviving row. Reads only
        the predicate columns (use ``scan_batches`` for ids + data in one
        pass)."""
        parts, bounds = [], {}
        for task, res in self._execute(output_columns=(),
                                       parallelism=parallelism,
                                       io_depth=io_depth):
            if task.shard not in bounds:
                bounds[task.shard] = \
                    _group_bounds(self._source.footer(task.shard))
            parts.append(self._source.row_offset(task.shard)
                         + bounds[task.shard][task.group] + res.row_ids)
        return np.concatenate(parts).astype(np.int64) if parts \
            else np.zeros(0, np.int64)

    def count_rows(self, *, parallelism: int = 1, io_depth: int = 1) -> int:
        """Number of surviving rows. Without a predicate or pinned rows this
        is answered from footers alone — zero data preads."""
        p = self._plan
        self.plan()                    # validate even on the metadata path
        if p.predicate is None and p.row_ids is None:
            total = 0
            for s in range(self._source.n_shards):
                fv = self._source.footer(s)
                groups = p.groups if p.groups is not None \
                    else range(fv.n_groups)
                for g in groups:
                    total += executor.visible_row_count(fv, g) \
                        if p.drop_deleted else executor.raw_row_count(fv, g)
            return total if p.limit is None else min(total, p.limit)
        return sum(len(res.row_ids)
                   for _, res in self._execute(output_columns=(),
                                               parallelism=parallelism,
                                               io_depth=io_depth))

    def profile(self, path: Optional[str] = None, *,
                parallelism: int = 1, io_depth: int = 1):
        """Execute the plan under a scoped tracer and return the collected
        ``obs.export.Profile`` (spans + Chrome ``trace_event`` rendering).
        ``path`` additionally writes the trace JSON — open it in Perfetto
        (ui.perfetto.dev) or chrome://tracing. Results are discarded; use
        ``BULLION_TRACE=path`` to trace a real workload instead."""
        from ..obs.export import Profile
        with _trace.collect() as tracer:
            for _ in self._execute(parallelism=parallelism,
                                   io_depth=io_depth):
                pass
        prof = Profile(tracer)
        if path is not None:
            prof.write(path)
        return prof

    # -- write path (materialization sink) ---------------------------------------
    def write_to(self, out_dir: str, *, shard_rows: Optional[int] = None,
                 rows_per_group: Optional[int] = None,
                 page_rows: Optional[int] = None, sort_by=None,
                 compliance: Optional[int] = None, parallelism: int = 1,
                 io_depth: int = 1, collect_stats: bool = True,
                 use_advisor: bool = True):
        """Materialize this plan into a fresh sharded dataset (current
        format: v2 page-indexed shards) under ``out_dir`` (the read/write
        loop's write half — see ``repro.dataset.sink``).

        The surviving rows of the plan — filters, projections, ``head``
        limits, and dequantization all compose — are re-encoded into
        ``part-NNNNN.bln`` shards: deletion-vector rows are physically
        purged (``verify_deleted`` reports zero raw occurrences), fresh
        zone maps are collected, and cascade encoding selection re-runs per
        chunk seeded by the chunk statistics. ``shard_rows`` rotates output
        shards every N rows; ``sort_by`` re-clusters by a column name (stable
        ascending) or any ``SortUDF`` (e.g. ``quality_sort``) so zone maps on
        the sort column become selective; ``page_rows`` sets the output page
        budget (default: the input's recorded budget), with each page
        re-encoded from its own statistics; ``parallelism`` decodes input
        groups on a thread pool with deterministic output, and
        ``io_depth > 1`` pipelines the read side's preads against decode
        (the write half is unaffected). The read half runs on this dataset's
        device: ``.where`` runs the range filter and ``.dequantized()`` the
        dequant kernel there; the write half is the host writer, whose files
        do not depend on the device. Returns a ``WriteResult``."""
        from .sink import write_dataset
        return write_dataset(self, out_dir, shard_rows=shard_rows,
                             rows_per_group=rows_per_group,
                             page_rows=page_rows, sort_by=sort_by,
                             compliance=compliance, parallelism=parallelism,
                             io_depth=io_depth, collect_stats=collect_stats,
                             use_advisor=use_advisor)

    def delete_where(self, predicate: Predicate, level=None):
        """Multi-shard compliance delete: erase every row matching
        ``predicate`` across all shards (global row ids are translated to
        each shard's local raw row space, then ``core.deletion.delete_rows``
        runs per affected shard). Returns the aggregated ``DeleteStats``.
        The victims are located by this dataset's plan, on its device: a
        float32 range predicate runs the range filter there.

        When rows were deleted the shard files were rewritten underneath
        this dataset, so the instance is closed and marked stale — reopen
        with ``dataset()`` to observe the deletion."""
        import dataclasses

        from ..core.deletion import Compliance, DeleteStats, delete_rows

        level = Compliance.LEVEL2 if level is None else level
        ids = self.where(predicate).drop_deleted(False).row_ids()
        total = DeleteStats()
        self.close()                  # close() is recoverable; reopen on use
        if not len(ids):
            return total
        located: list[tuple[str, np.ndarray]] = []
        for s in range(self._source.n_shards):
            lo, hi = self._source.row_offset(s), self._source.row_offset(s + 1)
            local = ids[(ids >= lo) & (ids < hi)] - lo
            if len(local):
                located.append((self._source.paths[s], local))
        self._source.invalidate("delete_where rewrote shard files")
        for path, local in located:
            st = delete_rows(path, local, level)
            for f in dataclasses.fields(DeleteStats):
                setattr(total, f.name,
                        getattr(total, f.name) + getattr(st, f.name))
        return total

    def _empty_column(self, name: str):
        """Typed empty result for a column no batch produced: scalar columns
        keep their (logical or storage) dtype, list/string columns are []."""
        from ..core.encodings.base import code_dtype
        fv = self._source.footer(0)
        c = fv.column_index(name)
        kind = int(fv.arr(Sec.COL_KIND, np.uint8)[c])
        if kind not in (int(ColKind.SCALAR), int(ColKind.MEDIA_REF)):
            return []
        sec = Sec.COL_LOGICAL if (self._plan.dequantize
                                  and kind == int(ColKind.SCALAR)) \
            else Sec.COL_DTYPE
        return np.zeros(0, code_dtype(int(fv.arr(sec, np.uint8)[c])))

    # -- lifecycle --------------------------------------------------------------
    def close(self) -> None:
        """Close shard readers this dataset owns (idempotent)."""
        self._source.close()

    def __enter__(self) -> "Dataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        p = self._plan
        bits = [f"shards={self.n_shards}", f"rows={self.num_rows}"]
        if p.columns is not None:
            bits.append(f"select={list(p.columns)}")
        if p.predicate is not None:
            bits.append(f"where={p.predicate!r}")
        if p.limit is not None:
            bits.append(f"head={p.limit}")
        return f"Dataset({', '.join(bits)})"


def _concat_tables(tables: list[dict], columns: Sequence[str],
                   empty=None) -> dict:
    out: dict = {}
    for name in columns:
        parts = [t[name] for t in tables if name in t]
        if not parts:
            out[name] = empty(name) if empty is not None else []
        elif isinstance(parts[0], np.ndarray):
            out[name] = parts[0] if len(parts) == 1 else np.concatenate(parts)
        else:
            out[name] = [r for p in parts for r in p]
    return out
