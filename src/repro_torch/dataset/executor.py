"""Physical-plan execution: the one read pipeline.

Every read path in the system — ``Dataset`` terminals, the legacy
``BullionReader.project``/``find_rows`` shims, ``Scanner.scan``, the
training loader, quality-filtered reads, and predicate deletes — bottoms
out in ``execute_group``, which orders the stages exactly once:

    prune (done at plan time) -> pread (coalesced) -> decode ->
    deletion-mask -> dequantize -> filter -> gather

``decode_group`` is the pread+decode+mask+dequantize core (moved here from
``BullionReader.project``); its bit-packed pages (``fixed_bit_width``,
``dictionary``) are decoded on the card (``page_route``,
``kernels.page_unpack``, one launch a call, deletion vectors applied in
it), the other pages on the host; its dequantize runs in the dequant kernel
on the card (``kernels.dequant``, one launch for the BF16 and
affine-integer columns of a call), in NumPy for the other modes.
``execute_group`` layers predicate evaluation (NumPy or the range-filter
kernel on the card, ``kernels.filter``) and raw-row-id selection on top.
Results are NumPy tables on the host: the packed pages, the quantized codes
and the filter's columns go to the device, the values and the mask come
back.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np
import torch

from ..core import integrity as _integrity
from ..core import pages as pages_mod
from ..core.footer import ColKind, PageType, Sec, ShardCorruptError
from ..core.encodings.base import code_dtype
from ..core.quantization import QuantMode, dequantize, storage_dtype
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..scan.predicate import Predicate, conjunctive_ranges, evaluate
from ..kernels.page_unpack import Page
from .page_route import Column, DeviceDecode

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from ..core.reader import BullionReader


@dataclass
class GroupResult:
    """Matching rows of one row group (row ids are group-local, raw space)."""

    row_ids: np.ndarray
    table: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# decode core: pread -> decode -> deletion-mask -> dequantize
# ---------------------------------------------------------------------------


def table_nbytes(table: dict) -> int:
    """Payload bytes of a result table: array ``nbytes`` plus per-row bytes
    for list/string columns. The query log's byte accounting — what a
    terminal handed back, not what the wire encoding costs."""
    total = 0
    for col in table.values():
        nbytes = getattr(col, "nbytes", None)
        if nbytes is not None:
            total += int(nbytes)
        else:
            for row in col:
                total += int(getattr(row, "nbytes", None) or len(row))
    return total


def _chunk_page_ids(fv, group: int, col: int,
                    pages: Optional[Sequence[int]]) -> list[int]:
    """Physical page indices of one chunk, restricted to the page-ordinal
    selection a plan produced (None = every page)."""
    s, e = fv.chunk_pages(group, col)
    return list(range(s, e)) if pages is None else [s + int(k) for k in pages]


def _pad_raw(decoded, dv: Optional[np.ndarray], page_rows: int):
    """Re-align one page's decode to its raw row space (drop_deleted=False):
    compact-deleted pages (§2.1 RLE rule) physically removed rows, so erased
    positions are re-padded with 0 — the same value in-place masking writes —
    to keep raw row ids stable."""
    if not isinstance(decoded, np.ndarray):
        return decoded
    if len(decoded) >= page_rows:
        return decoded[:page_rows]
    out = np.zeros(page_rows, decoded.dtype)
    out[np.flatnonzero(~dv)] = decoded
    return out


# page-type flag -> histogram name, cached (per-family decode-time metric)
_FAMILY_HIST: dict[int, str] = {}


def _decode_page_timed(flag: int, blob: bytes):
    """Traced-mode decode: per-page wall time lands in the per-encoding-
    family histogram (``bullion.decode.page_seconds.<family>``). Only the
    host route's pages are timed so; the device route's are counted in
    ``bullion.decode.pages_device`` and timed by their call's spans."""
    t0 = time.perf_counter()
    decoded = pages_mod.decode_page(flag, blob)
    dt = time.perf_counter() - t0
    name = _FAMILY_HIST.get(flag)
    if name is None:
        try:
            fam = PageType(flag).name.lower()
        except ValueError:
            fam = f"type{flag}"
        name = _FAMILY_HIST[flag] = f"bullion.decode.page_seconds.{fam}"
    _metrics.histogram(name).observe(dt)
    return decoded


def _mask_fill(fv, col: int, rows: int):
    """Shape-stable zero fill for a quarantined page under the ``mask``
    corruption policy: scalar/media_ref pages decode to zeros of the
    storage dtype, list pages to empty arrays, string pages to empty
    strings — same row count and types as a healthy decode."""
    from ..core.encodings.base import code_dtype
    kind = int(fv.arr(Sec.COL_KIND, np.uint8)[col])
    dt = code_dtype(int(fv.arr(Sec.COL_DTYPE, np.uint8)[col]))
    if kind == int(ColKind.LIST):
        return [np.zeros(0, dt)] * rows
    if kind == int(ColKind.STRING):
        return [b""] * rows
    return np.zeros(rows, dt)


# the modes the dequant kernel computes (the TPU kernel's two bodies); FP16,
# FP8 and the dual-FP16 halves stay in NumPy, as the reference computes them
_KERNEL_QUANT_MODES = frozenset({QuantMode.BF16, QuantMode.INT8_AFFINE,
                                 QuantMode.UINT8_AFFINE,
                                 QuantMode.INT16_AFFINE})


def _kernel_codes(mode: QuantMode) -> np.dtype:
    """The codes the dequant kernel reads for ``mode``: bf16 bits as
    uint16, or the affine storage dtype."""
    return np.dtype(np.uint16 if mode == QuantMode.BF16
                    else storage_dtype(mode))


def decode_group(reader: "BullionReader", names: Sequence[str], group: int, *,
                 drop_deleted: bool = True, dequant: bool = True,
                 pages: Optional[Sequence[int]] = None,
                 align_raw: bool = False,
                 masked_out: Optional[set] = None,
                 use_kernel: Optional[bool] = None, device=None) -> dict:
    """Decode one row group's columns via coalesced preads.

    ``pages`` restricts the read to a plan's surviving page ordinals (the
    same ordinals for every column — pages of one ordinal cover one row
    range group-wide). ``align_raw`` pads compact-deleted pages back to the
    raw row space (only meaningful with ``drop_deleted=False``); the default
    keeps physical page content, which ``verify_deleted`` audits.

    ``use_kernel`` and ``device`` choose the routes. Unless ``use_kernel``
    is False, the call's ``fixed_bit_width`` and ``dictionary`` scalar
    pages are decoded on ``device`` (default ``cuda``) in one launch of the
    page-unpack kernel, their deletion vectors applied there
    (``page_route``), and the BF16 and affine-integer columns are
    dequantized, after every column is decoded, in one call of the dequant
    kernel's column-list body on ``device``; the unpack writes its pages
    of those columns straight into that kernel's staging on the device.
    Every other page is decoded on the host, and the other quantization
    modes, and every mode and page under ``use_kernel=False``, go through
    NumPy (``decode_page``, ``apply_dv``, ``dequantize``, a column at a
    time). The counters ``bullion.decode.pages_device`` and
    ``bullion.decode.pages_host`` count the pages of each route.

    Each stage is a distinct span (``decode.pread`` / ``decode.decode`` /
    ``decode.mask`` / ``decode.dequantize``) so traces and
    ``explain(analyze=True)`` attribute time per stage; with tracing
    disabled the spans are shared no-ops and the stage order is the only
    (behavior-identical) difference from an uninstrumented decode. A
    ``decode.decode`` span names its column's ``route`` (``device`` when a
    page of it took the device route, else ``host``); the call's device
    work (its staging, one copy in, the unpack and dequant launches, one
    copy back and one synchronisation) runs inside the last column's
    ``decode.mask`` span, or its ``decode.decode`` span when nothing is
    masked, once every host page is final. A ``decode.dequantize`` span
    names its ``columns`` and ``route``: one span for the kernel's columns
    (which hands out what that device work brought back), one for each
    NumPy column. The ``bullion.decode.page_seconds.<family>`` histograms
    of a traced decode time the host route's pages only.
    """
    fv = reader.footer
    cols = [fv.column_index(n) for n in names]
    kinds = fv.arr(Sec.COL_KIND, np.uint8)
    dtypes = fv.arr(Sec.COL_DTYPE, np.uint8)
    flags = fv.arr(Sec.PAGE_FLAGS, np.uint8)
    page_rows = fv.arr(Sec.PAGE_ROWS, np.uint32)
    wanted: list[int] = []
    for c in cols:
        wanted.extend(_chunk_page_ids(fv, group, c, pages))
    sp = _trace.span("decode.pread", cat="io", group=group, pages=len(wanted))
    with sp:
        raw = reader._read_pages(wanted)
        if sp.enabled:
            sp.set(bytes=sum(len(b) for b in raw.values()))
    traced = _trace.enabled()
    route = DeviceDecode(device) if use_kernel is not False else None

    def _dec(c: int, p: int, dtype: np.dtype):
        blob = raw.get(p)
        if blob is None:
            # the verification gate removed a quarantined page (corruption
            # policy ``mask``): serve shape-stable zeros instead of failing
            # the whole group. Anything else missing is a real bug.
            if not _integrity.QUARANTINE.contains(reader.path, fv, p):
                raise KeyError(p)
            if masked_out is not None:
                masked_out.add(p)
            return _mask_fill(fv, c, int(page_rows[p]))
        flag = int(flags[p]) & 0x7F
        if route is not None and flag == PageType.SCALAR:
            page = route.take(
                blob, int(page_rows[p]), dtype,
                fv.deletion_vector(p) if drop_deleted else None,
                align=align_raw and not drop_deleted)
            if page is not None:
                return page
        if traced:
            return _decode_page_timed(flag, blob)
        return pages_mod.decode_page(flag, blob)

    masking = drop_deleted or align_raw
    columns: list[Column] = []
    specs: list = []
    for k, (name, c) in enumerate(zip(names, cols)):
        pids = _chunk_page_ids(fv, group, c, pages)
        spec = reader.quant_spec(c) \
            if dequant and kinds[c] == int(ColKind.SCALAR) else None
        col = Column(name, code_dtype(int(dtypes[c])))
        if route is not None and spec is not None \
                and spec.mode in _KERNEL_QUANT_MODES:
            col.dtype = _kernel_codes(spec.mode)
            col.params = (spec.scale, spec.zero)
        columns.append(col)
        specs.append(spec)
        last = k == len(names) - 1 and route is not None
        sp = _trace.span("decode.decode", cat="decode",
                         column=name, pages=len(pids))
        with sp:
            col.parts = [_dec(c, p, col.dtype) for p in pids]
            if sp.enabled:
                sp.set(route="device" if any(isinstance(x, Page)
                                             for x in col.parts) else "host")
            if last and not masking:
                route.launch(columns)
        if masking:
            with _trace.span("decode.mask", cat="decode", column=name):
                for i, p in enumerate(pids):
                    if isinstance(col.parts[i], Page):
                        continue        # the unpack's gather applies the DV
                    if drop_deleted:
                        col.parts[i] = pages_mod.apply_dv(
                            col.parts[i], fv.deletion_vector(p),
                            int(page_rows[p]))
                    else:
                        col.parts[i] = _pad_raw(
                            col.parts[i], fv.deletion_vector(p),
                            int(page_rows[p]))
                if last:
                    route.launch(columns)
    n_device = 0 if route is None else route.taken
    _metrics.counter("bullion.decode.pages_device").inc(n_device)
    _metrics.counter("bullion.decode.pages_host").inc(len(wanted) - n_device)
    out: dict = {}
    staged = [col.name for col in columns if col.params is not None]
    for col, spec in zip(columns, specs):
        if col.params is not None:
            out[col.name] = None        # the dequant kernel's, below
            continue
        parts = col.parts
        val = col.value if col.value is not None \
            else parts[0] if len(parts) == 1 else _concat(parts)
        if spec is not None and spec.mode != QuantMode.NONE:
            with _trace.span("decode.dequantize", cat="decode",
                             columns=[col.name], route="numpy"):
                val = dequantize(np.asarray(val), spec)
        out[col.name] = val
    if staged:
        with _trace.span("decode.dequantize", cat="decode", columns=staged,
                         route="kernel"):
            out.update(zip(staged, route.dequantize()))
    return out


# ---------------------------------------------------------------------------
# row-space helpers (footer-only: planning never needs a file handle)
# ---------------------------------------------------------------------------


def raw_row_count(fv, group: int) -> int:
    return int(fv.arr(Sec.ROWS_PER_GROUP, np.uint32)[group])


def group_keep(fv, group: int, col: int = 0,
               pages: Optional[Sequence[int]] = None) -> Optional[np.ndarray]:
    """Raw-row keep mask from deletion vectors (None = nothing deleted),
    over the selected pages' rows when ``pages`` restricts the chunk."""
    page_rows = fv.arr(Sec.PAGE_ROWS, np.uint32)
    parts, any_dv = [], False
    for p in _chunk_page_ids(fv, group, col, pages):
        dv = fv.deletion_vector(p)
        if dv is None:
            parts.append(np.ones(int(page_rows[p]), bool))
        else:
            parts.append(~dv)
            any_dv = True
    return np.concatenate(parts) if any_dv else None


def visible_row_count(fv, group: int) -> int:
    keep = group_keep(fv, group)
    return raw_row_count(fv, group) if keep is None else int(keep.sum())


def selected_raw_rows(fv, group: int,
                      pages: Optional[Sequence[int]]) -> Optional[np.ndarray]:
    """Group-local raw row ids covered by a page-ordinal selection (None =
    the whole group). Pages partition a chunk's rows in order, so ordinal k
    covers rows [starts[k], starts[k+1]) — identical for every column."""
    if pages is None:
        return None
    rows = fv.chunk_page_rows(group, 0).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(rows)])
    if not len(pages):
        return np.zeros(0, np.int64)
    return np.concatenate([np.arange(starts[k], starts[k + 1])
                           for k in pages])


# ---------------------------------------------------------------------------
# predicate evaluation (NumPy or the range-filter kernel)
# ---------------------------------------------------------------------------


def _f32_shrink(lo: float, hi: float) -> tuple[np.float32, np.float32]:
    """Tightest float32 interval inside the float64 one.

    Exact for float32 column data: a float32 x satisfies lo <= x <= hi iff
    it satisfies the shrunk float32 bounds. A strict bound shrinks by one
    ulp, so ``x > 0`` becomes ``x >= 1e-45``, a subnormal: the kernel must
    compare subnormals exactly (no flush to zero).
    """
    lo32, hi32 = np.float32(lo), np.float32(hi)
    if np.float64(lo32) < lo:
        lo32 = np.nextafter(lo32, np.float32(np.inf), dtype=np.float32)
    if np.float64(hi32) > hi:
        hi32 = np.nextafter(hi32, np.float32(-np.inf), dtype=np.float32)
    return lo32, hi32


def _bf16_widened(fv, tbl: dict) -> dict:
    """The table a predicate reads: bfloat16 columns, decoded as their
    uint16 bits, widened to float32 (exact)."""
    from ..core.encodings.base import BF16_CODE, bf16_to_f32
    codes = fv.arr(Sec.COL_DTYPE, np.uint8)
    return {name: bf16_to_f32(v)
            if int(codes[fv.column_index(name)]) == BF16_CODE else v
            for name, v in tbl.items()}


def eval_mask(pred: Predicate, tbl: dict, use_kernel: Optional[bool],
              device=None) -> np.ndarray:
    """Predicate -> row mask; the range-filter kernel when the predicate
    compiles to conjunctive ranges over float32 columns (exact there), NumPy
    otherwise. The kernel route stacks the filter columns on the host,
    copies them to ``device`` (default ``cuda``), runs ``range_mask`` there
    and copies the mask back; on ``"cpu"`` it runs the plain version."""
    ranges = conjunctive_ranges(pred)
    kernel_ok = ranges is not None and all(
        isinstance(tbl[c], np.ndarray) and tbl[c].dtype == np.float32
        for c in ranges)
    if use_kernel and not kernel_ok:
        raise ValueError(
            "kernel filter path requires a conjunctive range predicate "
            "over float32 columns")
    if use_kernel is None:
        use_kernel = kernel_ok
    if not use_kernel:
        return evaluate(pred, tbl)
    from .. import resolve_device
    from ..kernels.filter import range_mask
    dev = resolve_device(device)
    names = list(ranges)
    bounds = np.asarray([_f32_shrink(*ranges[c]) for c in names],
                        np.float32).reshape(-1, 2).T
    cols = np.stack([np.asarray(tbl[c], np.float32) for c in names])
    lo, hi = torch.from_numpy(np.ascontiguousarray(bounds)).to(dev)
    mask = range_mask(torch.from_numpy(cols).to(dev), lo, hi, device=dev)
    return mask.cpu().numpy()


# ---------------------------------------------------------------------------
# the one per-group pipeline
# ---------------------------------------------------------------------------


def _page_ordinal(fv, group: int, page: int) -> int:
    """Page ordinal (position within its chunk) of a physical page. Every
    column of a group splits at the same row boundaries, so one ordinal
    names the same row range in every chunk."""
    for c in range(fv.n_cols):
        s, e = fv.chunk_pages(group, c)
        if s <= page < e:
            return page - s
    raise ValueError(f"page {page} not in group {group}")


def execute_group(reader: "BullionReader", group: int, *,
                  columns: Sequence[str] = (),
                  predicate: Optional[Predicate] = None,
                  rows: Optional[np.ndarray] = None,
                  drop_deleted: bool = True, dequant: bool = True,
                  use_kernel: Optional[bool] = None,
                  pages: Optional[Sequence[int]] = None, device=None
                  ) -> Optional[GroupResult]:
    """Decode + filter one row group with graceful degradation.
    ``device`` is where the dequantize (``decode_group``) and the range
    filter (``eval_mask``) run.

    The inner pipeline (``_execute_group_once``) raises
    ``ShardCorruptError`` when decode-time verification quarantines a page.
    Under the ``skip`` corruption policy that page's *ordinal* is excluded
    (dropping the same row range from every column — the result stays
    rectangular) and the group retries; dropped rows are charged exactly
    once to ``IOStats.degraded_rows``. Under ``mask`` the verification gate
    already zero-filled the page; the masked rows are charged here. Under
    ``raise`` (the default) the error propagates with (shard, group, page).
    """
    fv = reader.footer
    policy = _integrity.corruption_policy()
    masked_out: Optional[set] = set() \
        if policy == _integrity.ON_CORRUPT_MASK else None
    if policy != _integrity.ON_CORRUPT_SKIP:
        res = _execute_group_once(
            reader, group, columns=columns, predicate=predicate, rows=rows,
            drop_deleted=drop_deleted, dequant=dequant, use_kernel=use_kernel,
            pages=pages, masked_out=masked_out, device=device)
        if masked_out:
            page_rows = fv.arr(Sec.PAGE_ROWS, np.uint32)
            _charge_degraded(
                reader, sum(int(page_rows[p]) for p in masked_out))
        return res

    # skip mode: pre-exclude ordinals already quarantined for this exact
    # footer object, then retry as verification quarantines new ones
    n_ord = len(fv.chunk_page_rows(group, 0))
    excluded: set[int] = set()
    for p, (g, _reason) in _integrity.QUARANTINE.lookup(
            reader.path, fv).items():
        if g == group:
            excluded.add(_page_ordinal(fv, group, p))
    selected = set(range(n_ord)) if pages is None \
        else {int(k) for k in pages}
    for _ in range(n_ord + 1):
        if excluded:
            eff = sorted(selected - excluded)
        else:
            eff = pages
        try:
            res = _execute_group_once(
                reader, group, columns=columns, predicate=predicate,
                rows=rows, drop_deleted=drop_deleted, dequant=dequant,
                use_kernel=use_kernel, pages=eff, device=device)
        except ShardCorruptError as e:
            if e.page is None or e.path != reader.path:
                raise
            k = _page_ordinal(fv, group, e.page)
            if k in excluded:       # no progress: don't loop forever
                raise
            excluded.add(k)
            continue
        dropped = excluded & selected
        if dropped:
            rows_per = fv.chunk_page_rows(group, 0)
            _charge_degraded(
                reader, sum(int(rows_per[k]) for k in dropped))
        return res
    raise AssertionError("unreachable: every ordinal excluded")  # pragma: no cover


def _charge_degraded(reader: "BullionReader", n_rows: int) -> None:
    if not n_rows:
        return
    with reader._stats_lock:
        reader.stats.degraded_rows += n_rows
    _metrics.counter("bullion.integrity.degraded_rows").inc(n_rows)


def _execute_group_once(reader: "BullionReader", group: int, *,
                        columns: Sequence[str] = (),
                        predicate: Optional[Predicate] = None,
                        rows: Optional[np.ndarray] = None,
                        drop_deleted: bool = True, dequant: bool = True,
                        use_kernel: Optional[bool] = None,
                        pages: Optional[Sequence[int]] = None,
                        masked_out: Optional[set] = None, device=None
                        ) -> Optional[GroupResult]:
    """Decode + filter one row group. Returns None when a predicate or a
    row-id selection leaves no rows (payload pages are then never read).

    ``pages`` is a plan's surviving page-ordinal selection: only those
    pages are pread and decoded for every column, and reported row ids stay
    in the group's raw row space (each ordinal maps to its row range).

    Predicate columns are always evaluated in the dequantized (logical)
    domain — the domain the zone maps describe; ``dequant`` governs only the
    materialized payload. When the caller wants raw values of a predicate
    column, it is re-read in the payload pass instead of served from the
    evaluation copy.
    """
    fv = reader.footer
    if pages is not None and not len(pages):
        return None
    sel_raw = selected_raw_rows(fv, group, pages)
    keep = group_keep(fv, group, pages=pages) if drop_deleted else None
    if keep is not None:
        space_raw = sel_raw[keep] if sel_raw is not None \
            else np.flatnonzero(keep)
    else:
        space_raw = sel_raw
    n_space = len(space_raw) if space_raw is not None \
        else raw_row_count(fv, group)

    pred_cols = sorted(predicate.columns()) if predicate is not None else []
    reuse = set(pred_cols) if dequant else set()
    tbl: dict = {}
    mask: Optional[np.ndarray] = None
    if predicate is not None:
        # compact-deleted pages shrink their decode; align_raw re-pads each
        # page to its raw row space so mask indices line up with space_raw
        tbl = decode_group(reader, pred_cols, group,
                           drop_deleted=drop_deleted, dequant=True,
                           pages=pages, align_raw=not drop_deleted,
                           masked_out=masked_out, use_kernel=use_kernel,
                           device=device)
        sp = _trace.span("exec.filter", cat="exec", group=group)
        with sp:
            mask = eval_mask(predicate, _bf16_widened(fv, tbl), use_kernel,
                             device)
            if sp.enabled:
                sp.set(rows_in=int(len(mask)), rows_out=int(mask.sum()))
    if rows is not None:
        rmask = np.zeros(n_space, bool)
        if space_raw is None:
            rmask[rows[rows < n_space]] = True
        else:
            rmask[np.isin(space_raw, rows)] = True
        mask = rmask if mask is None else mask & rmask

    if mask is None:
        local = np.arange(n_space)
        full = True
    else:
        if not mask.any():
            return None
        local = np.flatnonzero(mask)
        full = len(local) == n_space
    raw_local = local if space_raw is None else space_raw[local]

    out: dict = {}
    for name in columns:
        if name in reuse and name in tbl:
            out[name] = tbl[name] if full else _take(tbl[name], local)
    rest = [c for c in columns if c not in out]
    if rest:
        # drop_deleted=False means *raw row space*, always: compact-deleted
        # pages decode short, so every page is re-aligned (erased rows
        # read 0) to keep row_ids and all columns the same length.
        ptbl = decode_group(reader, rest, group,
                            drop_deleted=drop_deleted, dequant=dequant,
                            pages=pages, align_raw=not drop_deleted,
                            masked_out=masked_out, use_kernel=use_kernel,
                            device=device)
        for name in rest:
            out[name] = ptbl[name] if full else _take(ptbl[name], local)
    return GroupResult(row_ids=raw_local, table=out)


# ---------------------------------------------------------------------------
# parallel task execution (bounded thread pool, deterministic order)
# ---------------------------------------------------------------------------


def run_tasks(tasks, fn, parallelism: int = 1, io=None):
    """Execute ``fn(task)`` for every task, yielding ``(task, result)``
    strictly in task order.

    ``parallelism <= 1`` is the plain serial loop (zero overhead, the
    default). Above that, up to ``parallelism`` tasks run concurrently on a
    thread pool with a bounded in-flight window (results are buffered at
    most ``2 * parallelism`` deep), so a consumer that stops early — a
    ``head`` limit, an aborted iteration — never waits on more than the
    window. Per-(shard, row-group) tasks are independent and readers use
    positional I/O on one shared fd per shard, so ordering the *yields* is
    all determinism needs: parallel and serial runs produce identical
    streams.

    ``io`` is an optional pipelined I/O scheduler (``dataset.io
    .IOScheduler``) whose lifecycle this loop owns: started before the first
    task runs, closed when iteration finishes *or* is abandoned early, so
    its prefetch thread never outlives the scan. ``fn`` decides whether to
    pull its reader from the scheduler.
    """
    tasks = list(tasks)
    if io is not None:
        io.start()
    try:
        if parallelism <= 1 or len(tasks) <= 1:
            for t in tasks:
                yield t, fn(t)
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(max_workers=parallelism,
                                thread_name_prefix="bullion-scan")
        pending: deque = deque()
        it = iter(tasks)
        try:
            def fill() -> None:
                while len(pending) < 2 * parallelism:
                    t = next(it, None)
                    if t is None:
                        return
                    pending.append((t, ex.submit(fn, t)))

            fill()
            while pending:
                t, fut = pending.popleft()
                yield t, fut.result()
                fill()
        finally:
            for _, fut in pending:
                fut.cancel()
            ex.shutdown(wait=True)
    finally:
        if io is not None:
            io.close()


def truncate_result(res: GroupResult, n: int) -> GroupResult:
    """Keep the first n rows of a group result (head limit)."""
    return GroupResult(row_ids=res.row_ids[:n],
                       table={k: v[:n] for k, v in res.table.items()})


def _take(values, idx: np.ndarray):
    if isinstance(values, np.ndarray):
        return values[idx]
    return [values[i] for i in idx]


def _concat(parts):
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts)
    return [r for p in parts for r in p]
