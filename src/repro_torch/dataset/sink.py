"""Plan-driven materialization sink: the write half of the read/write loop.

``Dataset.write_to`` executes any optimized ``LogicalPlan`` — filters,
projections, ``head`` limits, and dequantization compose with rewrite — and
materializes the surviving rows into a fresh sharded dataset in the current
format (v2: multi-page chunks with a page index and zone maps):

* **compliance purge** — the executor resolves merge-on-read deletion
  vectors while streaming, so deleted rows are physically absent from the
  output (``deletion.verify_deleted`` reports zero raw occurrences),
* **resharding** — ``shard_rows=N`` rotates to a new ``part-NNNNN.bln``
  shard every N rows,
* **reclustering** — ``sort_by=`` re-sorts by a column (stable ascending) or
  any ``SortUDF`` such as ``quality_sort``, so zone maps on the sort column
  become selective again (zone maps are useless on unclustered columns),
* **re-encoding** — cascade encoding selection re-runs per output chunk,
  seeded by the chunk's min/max/distinct statistics through the LEA-style
  ``advise_candidates`` hook, and fresh ``Sec.PAGE_STATS`` /
  ``Sec.CHUNK_STATS`` zone maps are written.

Unsorted rewrites stream group-by-group (the writer's ``stream=True`` mode
holds at most one group per shard in memory); a ``sort_by`` rewrite must
materialize the surviving rows once to permute them globally. Input groups
decode on the shared bounded thread pool when ``parallelism > 1``, and
``io_depth > 1`` pipelines the read side through the I/O scheduler (the
next input group's preads overlap the current group's decode+encode) — with
deterministic output either way.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional, Union

import numpy as np

from ..core.encodings.base import code_dtype
from ..core.encodings.cascade import advise_candidates
from ..core.footer import ColKind, FooterView, PageType, Sec
from ..core.quantization import QUANT_DTYPE, QuantMode, QuantSpec
from ..core.writer import BullionWriter, ColumnSpec, SortUDF
from ..obs import trace as _trace

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from .core import Dataset

SortBy = Union[str, SortUDF]


@dataclass
class WriteResult:
    """What a ``Dataset.write_to`` materialization produced."""

    paths: list[str] = field(default_factory=list)
    rows: int = 0
    groups: int = 0
    pages: int = 0
    bytes_written: int = 0
    rows_per_shard: list[int] = field(default_factory=list)

    @property
    def shards(self) -> int:
        return len(self.paths)


def _uses_sparse_delta(fv: FooterView, col: int) -> bool:
    flags = fv.arr(Sec.PAGE_FLAGS, np.uint8)
    return any(int(flags[p]) & 0x7F == int(PageType.SPARSE_DELTA)
               for g in range(fv.n_groups)
               for p in range(*fv.chunk_pages(g, col)))


def output_schema(source, names, dequantize: bool) -> list[ColumnSpec]:
    """Derive the output ``ColumnSpec`` list from the input footers.

    Quantized scalar columns keep their quant spec when the plan reads the
    logical domain (the writer re-quantizes, which is idempotent for the
    float storage modes), and become plain columns of the storage dtype on
    ``dequantized(False)`` plans — raw reads materialize stored values, so
    the stored domain *is* the output's logical domain. List columns keep
    their §2.2 sparse-delta layout when any shard's pages used it (the size
    guard in ``build_list_page`` may have shipped plain pages shard by
    shard, so one shard's flags are not conclusive).
    """
    fv = source.footer(0)
    kinds = fv.arr(Sec.COL_KIND, np.uint8)
    logical = fv.arr(Sec.COL_LOGICAL, np.uint8)
    storage = fv.arr(Sec.COL_DTYPE, np.uint8)
    quant = fv.arr(Sec.QUANT_META, QUANT_DTYPE)
    specs: list[ColumnSpec] = []
    for name in names:
        c = fv.column_index(name)
        kind = ColKind(int(kinds[c]))
        if kind == ColKind.STRING:
            specs.append(ColumnSpec(name, "string"))
        elif kind == ColKind.MEDIA_REF:
            specs.append(ColumnSpec(name, "media_ref"))
        elif kind == ColKind.LIST:
            elem = code_dtype(int(logical[c])).name
            sd = any(_uses_sparse_delta(source.footer(s), c)
                     for s in range(source.n_shards))
            specs.append(ColumnSpec(name, f"list<{elem}>", sparse_delta=sd))
        else:
            q = QuantSpec.from_record(quant[c])
            if dequantize or q.mode == QuantMode.NONE:
                specs.append(ColumnSpec(
                    name, code_dtype(int(logical[c])).name, quant=q))
            else:
                specs.append(ColumnSpec(name, code_dtype(int(storage[c])).name))
    return specs


def _nrows(table: dict) -> int:
    return len(next(iter(table.values())))


def _slice(table: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in table.items()}


def _permute(table: dict, perm: np.ndarray) -> dict:
    return {k: v[perm] if isinstance(v, np.ndarray) else [v[i] for i in perm]
            for k, v in table.items()}


def write_dataset(ds: "Dataset", out_dir: str, *,
                  shard_rows: Optional[int] = None,
                  rows_per_group: Optional[int] = None,
                  page_rows: Optional[int] = None,
                  sort_by: Optional[SortBy] = None,
                  compliance: Optional[int] = None,
                  parallelism: int = 1,
                  io_depth: int = 1,
                  collect_stats: bool = True,
                  use_advisor: bool = True) -> WriteResult:
    """Execute ``ds``'s plan and materialize the result under ``out_dir``.

    See ``Dataset.write_to`` for the user-facing contract. ``compliance``,
    ``rows_per_group``, and ``page_rows`` default to the input's values
    (shard 0's footer; pre-page-index inputs fall back to the writer
    default); ``collect_stats=False`` writes v0 shards (the backward-compat
    target), so ``write_to`` also upgrades v0 datasets to the current
    format by default.
    Output chunks are split into pages of ``page_rows`` rows, each encoded
    independently with per-page stats feeding the encoding advisor.
    """
    opt = ds.plan()
    if not opt.output_columns:
        raise ValueError("write_to needs at least one output column")
    if shard_rows is not None and shard_rows <= 0:
        raise ValueError(f"shard_rows must be positive, got {shard_rows}")
    if isinstance(sort_by, str) and sort_by not in opt.output_columns:
        raise KeyError(
            f"sort_by column {sort_by!r} is not in the output columns "
            f"{list(opt.output_columns)}")
    src = ds._source
    fv = src.footer(0)
    if rows_per_group is None:
        rows_per_group = int(fv.meta[4]) or 65536
    if page_rows is None:
        recorded = fv.props().get("bullion.page_rows")
        page_rows = int(recorded) if recorded else None
    if compliance is None:
        compliance = fv.compliance
    schema = output_schema(src, opt.output_columns, opt.logical.dequantize)

    from .source import _is_bullion
    os.makedirs(out_dir, exist_ok=True)
    clash = [n for n in sorted(os.listdir(out_dir))
             if _is_bullion(os.path.join(out_dir, n))]
    if clash:
        raise FileExistsError(
            f"output directory {out_dir!r} already holds Bullion shard(s) "
            f"{clash[:3]}; refusing to mix datasets")

    advisor = advise_candidates if use_advisor else None
    result = WriteResult()
    writer: Optional[BullionWriter] = None
    shard_filled = 0

    def open_shard() -> BullionWriter:
        path = os.path.join(out_dir, f"part-{len(result.paths):05d}.bln")
        result.paths.append(path)
        result.rows_per_shard.append(0)
        return BullionWriter(path, schema, rows_per_group=rows_per_group,
                             page_rows=page_rows, compliance=compliance,
                             collect_stats=collect_stats, stream=True,
                             encoding_advisor=advisor,
                             props={"bullion.sink": "write_to"})

    def close_shard(w: BullionWriter) -> None:
        with _trace.span("sink.close_shard", cat="sink",
                         shard=len(result.paths) - 1):
            info = w.close()
        result.rows += info["rows"]
        result.groups += info["groups"]
        result.pages += info["pages"]
        result.bytes_written += os.path.getsize(w.path)

    def emit(table: dict) -> None:
        nonlocal writer, shard_filled
        n = _nrows(table)
        off = 0
        while off < n:
            if writer is None:
                writer = open_shard()
                shard_filled = 0
            take = n - off if shard_rows is None \
                else min(n - off, shard_rows - shard_filled)
            # per-group flush spans (write.group) come from the writer; this
            # span is the sink-side unit: one slice into one output shard
            with _trace.span("sink.write", cat="sink", rows=take,
                             shard=len(result.paths) - 1):
                writer.write_table(_slice(table, off, off + take))
            shard_filled += take
            result.rows_per_shard[-1] += take
            off += take
            if shard_rows is not None and shard_filled >= shard_rows:
                close_shard(writer)
                writer = None

    try:
        with _trace.span("sink.write_dataset", cat="sink",
                         out_dir=out_dir, shards_in=src.n_shards):
            if sort_by is not None:
                # a global re-cluster needs the whole surviving table at once
                from .core import _concat_tables
                parts = [res.table
                         for _, res in ds._execute(parallelism=parallelism,
                                                   io_depth=io_depth)]
                full = _concat_tables(parts, opt.output_columns)
                if parts and _nrows(full):
                    perm = sort_by(full) if callable(sort_by) else \
                        np.argsort(np.asarray(full[sort_by]), kind="stable")
                    emit(_permute(full, perm))
            else:
                for _, res in ds._execute(parallelism=parallelism,
                                          io_depth=io_depth):
                    emit(res.table)

            if writer is not None:
                close_shard(writer)
            elif not result.paths:
                # zero surviving rows: still materialize one empty,
                # openable shard
                close_shard(open_shard())
    except BaseException:
        # a failed rewrite must not leave half a dataset behind: finished
        # part files would read as a complete (wrong) dataset and block the
        # retry at the clash check above
        if writer is not None:
            writer.abort()
        for p in result.paths:
            for victim in (p, p + ".tmp"):
                try:
                    os.unlink(victim)
                except OSError:
                    pass
        raise
    return result
