"""Unified lazy ``Dataset`` API: logical/physical scan plans over Bullion data.

One plan-driven read path replaces five ad-hoc entry points. Chaining builds
a ``LogicalPlan``; the optimizer normalizes it (conjunct splitting,
projection narrowing to predicate+output columns, pushdown into the zone-map
``Scanner``) and lowers it to a ``PhysicalPlan`` of per-(shard, row-group)
tasks executed by the single pipeline in ``executor`` — the only code that
orders prune -> pread -> decode -> deletion-mask -> dequantize -> filter.
The same plan runs unchanged over a single file or a directory/glob of
schema-checked shards::

    from repro_torch.dataset import dataset
    from repro_torch.scan import C

    with dataset("shards/") as ds:          # file, dir, glob, or path list
        tbl = (ds.where(C("quality") >= 0.5)
                 .select(["tokens", "quality"])
                 .head(10_000)
                 .to_table())

Shards may also live in object storage: pass ``bullion://bucket/key`` URIs
(after ``repro_torch.core.backend.configure_object_store()`` or with
``BULLION_OBJECT_STORE`` set) and the same plans execute over ranged GETs,
with ``to_table(io_depth=N)`` bounding concurrent in-flight ranges.

Legacy surface -> plan equivalent (the legacy calls survive as deprecated
shims that build exactly these one-file plans):

    =======================================================  =====================================================================
    legacy call                                              Dataset plan
    =======================================================  =====================================================================
    ``BullionReader.project(cols, predicate=p)``             ``Dataset.from_reader(r).select(cols).where(p).to_batches()``
    ``BullionReader.read_column(c)``                         ``Dataset.from_reader(r).select([c]).to_table()[c]``
    ``BullionReader.find_rows(col, vals)``                   ``Dataset.from_reader(r).where(In(col, vals)).drop_deleted(False).row_ids()``
    ``Scanner.scan(p, columns=cols)``                        ``dataset(path).where(p).select(cols).to_batches()``
    ``BullionLoader(path, predicate=p, column=c)``           ``dataset(path).where(p).select([c])`` + ``tasks()``/``read_group()``
    ``quality_filtered_read(path, cols, frac)``              ``dataset(path).select(cols).head(n).to_batches()``
    ``deletion.delete_where(path, p)``                       ``dataset(path).where(p).drop_deleted(False).row_ids()`` -> ``delete_rows``
    =======================================================  =====================================================================

Layout:

  plan.py      — ``LogicalPlan``/``OptimizedPlan``/``PhysicalPlan``/``ScanTask``,
                 the ``optimize`` and ``lower`` passes
  source.py    — shard discovery (file/dir/glob/list), open-time schema
                 checking (``SchemaMismatchError``), reader lifecycle,
                 global row offsets, aggregate ``IOStats``
  executor.py  — ``decode_group``/``execute_group``: the one read pipeline,
                 plus ``run_tasks`` (bounded thread pool, deterministic order)
                 shared by parallel reads and the sink
  io.py        — ``IOScheduler``/``PrefetchReader``: plan-wide byte-range
                 scheduling (``io_depth=`` on every terminal) — cross-task
                 pread coalescing and a prefetch thread that overlaps the
                 next tasks' reads with the current decode
  sink.py      — ``write_dataset``/``WriteResult``: the plan-driven
                 materialization sink behind ``Dataset.write_to`` (compaction
                 / compliance purge, resharding, reclustering, re-encoding)
  core.py      — the chainable ``Dataset`` and the ``dataset()`` entry point
"""

from .core import Dataset, DatasetBatch, dataset
from .executor import GroupResult, decode_group, execute_group, run_tasks
from .io import IOScheduler, PrefetchReader
from .plan import (LogicalPlan, OptimizedPlan, PhysicalPlan, ScanTask, lower,
                   optimize, split_conjuncts)
from .sink import WriteResult, write_dataset
from .source import (DataSource, SchemaMismatchError, cached_footer,
                     clear_footer_cache, discover, invalidate_cached_footer)

__all__ = [
    "Dataset", "DatasetBatch", "dataset", "DataSource",
    "SchemaMismatchError", "discover",
    "GroupResult", "decode_group", "execute_group", "run_tasks",
    "IOScheduler", "PrefetchReader",
    "LogicalPlan", "OptimizedPlan", "PhysicalPlan", "ScanTask", "lower",
    "optimize", "split_conjuncts", "WriteResult", "write_dataset",
    "cached_footer", "clear_footer_cache", "invalidate_cached_footer",
]
