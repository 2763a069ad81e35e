"""Pipelined I/O: plan-wide byte-range scheduling with decode overlap.

Serial execution preads each task's pages from inside the decode loop — the
CPU stalls on every group boundary, and range coalescing stops at the group
the call happens to be decoding. Lowered plans already know *every* surviving
page byte range (``ScanTask.pages`` + the footer's page index), so the
``IOScheduler`` lifts I/O out of the decode path entirely:

1. **collect** — for each task, the byte extents of every page the executor
   will touch (the predicate columns when a filter gates payload reads, the
   full read set otherwise), computed footer-only before any data pread;
2. **coalesce** — extents merge across page, column, *and row-group/task*
   boundaries on the same shard whenever the hole between them is at most
   the reader's ``coalesce_gap`` (``BULLION_COALESCE_GAP`` / the
   ``dataset(coalesce_gap=)`` argument), capped at ``io_depth`` tasks and
   ``MAX_RUN_BYTES`` per submission so buffering stays bounded;
3. **prefetch** — a scheduler thread issues the coalesced runs through the
   shard's *shared* reader fd (positional reads; no second handle) at most
   ``io_depth - 1`` tasks ahead of the newest task the executor asked for,
   so task k+1's preads overlap task k's decode (``io_depth=2`` is classic
   double buffering).

The executor consumes prefetched bytes through ``reader_for(i)``: a
``PrefetchReader`` proxy that serves ``_read_pages`` from the task's buffer
and falls back to the underlying reader for anything not prefetched (payload
pages behind a filter, or after a scheduler error — correctness never
depends on the prefetch path). Output is byte-identical to serial execution
by construction: the same pages decode in the same task order; only *when*
and *how batched* the preads happen changes. ``IOStats.coalesced_preads`` /
``wasted_bytes`` account the batching win and its hole-read cost.

This scheduler is the seam storage backends plug into: the run list from
``_plan_runs`` is handed to ``BullionReader._fetch_runs`` in per-shard
batches, and the backend decides how a batch is fetched — one blocking
``pread`` per run for local files (byte-identical to serial execution), or
concurrent object-store ranged GETs with bounded in-flight requests and
completion-order staging for ``bullion://`` shards (``repro_torch.core.backend``).
Backends replace how a coalesced run is fetched, not how plans or decoders
work; a failed run fails only the tasks it covers (they fall back to the
direct read path, which surfaces the real error).
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional, Sequence

from ..core import backend as _backend
from ..core import integrity as _integrity
from ..core.reader import BullionReader
from ..obs import metrics as _metrics
from ..obs import trace as _trace

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from .plan import ScanTask
    from .source import DataSource

MAX_RUN_BYTES = 8 * 1024 * 1024   # cap one coalesced submission


def task_page_ids(fv, task: "ScanTask", columns: Sequence[str]) -> list[int]:
    """Physical page ids one task will read for ``columns`` (footer-only),
    honoring the plan's surviving page-ordinal subset."""
    from .executor import _chunk_page_ids
    wanted: list[int] = []
    for name in columns:
        c = fv.column_index(name)
        wanted.extend(_chunk_page_ids(fv, task.group, c, task.pages))
    return wanted


class PrefetchReader:
    """Reader proxy serving ``_read_pages`` from a task's prefetched bytes.

    Pages the scheduler didn't (or couldn't) stage are read through the
    underlying shared reader, so a partial prefetch degrades gracefully to
    the serial path instead of failing. Everything else (footer, stats,
    quant specs) delegates to the base reader.
    """

    def __init__(self, base: BullionReader, pages: dict[int, bytes]):
        self._base = base
        self._pages = pages

    def _read_pages(self, page_ids: Sequence[int]) -> dict[int, bytes]:
        out: dict[int, bytes] = {}
        missing: list[int] = []
        for p in page_ids:
            data = self._pages.get(p)
            if data is None:
                missing.append(p)
            else:
                out[p] = data
        # staged bytes get the same decode-time verification gate the serial
        # path applies; a mismatching staged page re-reads *directly* through
        # the base reader (bypassing the prefetch buffer) before declaring
        # corruption. The fallback reads below verify inside the base call.
        out = _integrity.verify_pages(self, out)
        if missing:
            # fallback reads run through the base reader's coalesced pread
            # path, so preads / coalesced_preads / wasted_bytes are charged
            # exactly like the serial path and explain(analyze=True)
            # reconciliation holds on a partial prefetch; the counter makes
            # the fallback volume visible next to the staged-page spans
            _metrics.counter("bullion.io.prefetch_fallback_pages") \
                .inc(len(missing))
            out.update(self._base._read_pages(missing))
        return out

    def __getattr__(self, name):
        return getattr(self._base, name)


class IOScheduler:
    """Bounded plan-wide prefetcher: one background thread submits coalesced
    byte-range runs for upcoming tasks while the executor decodes.

    ``io_depth`` bounds both how far reads run ahead of decode (at most
    ``io_depth - 1`` tasks past the newest one requested) and how many
    consecutive tasks one coalesced pread may span. ``io_depth=1`` is the
    degenerate case — callers should simply not construct a scheduler.
    """

    def __init__(self, source: "DataSource", tasks: Sequence["ScanTask"], *,
                 columns: Sequence[str], io_depth: int,
                 max_run_bytes: int = MAX_RUN_BYTES):
        if io_depth < 2:
            raise ValueError(f"IOScheduler needs io_depth >= 2, "
                             f"got {io_depth}")
        self._source = source
        self._tasks = list(tasks)
        self._depth = int(io_depth)
        self._max_run_bytes = int(max_run_bytes)
        self._cond = threading.Condition()
        self._buffers: dict[int, dict[int, bytes]] = {}
        self._left: dict[int, int] = {}
        self._done: set[int] = set()
        self._max_requested = -1
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        # footer-only planning: per-task eager pages, then per-shard-segment
        # extent runs coalesced across task boundaries
        eager: list[list[int]] = []
        for t in self._tasks:
            fv = source.footer(t.shard)
            pages = task_page_ids(fv, t, columns)
            eager.append(pages)
            self._left[len(eager) - 1] = len(pages)
            if not pages:
                self._done.add(len(eager) - 1)
            else:
                self._buffers[len(eager) - 1] = {}
        self._runs = self._plan_runs(eager)

    # -- planning ---------------------------------------------------------------
    def _plan_runs(self, eager: list[list[int]]):
        """Coalesce page extents into submission runs.

        Tasks are walked in plan order; consecutive tasks on one shard form a
        segment whose extents sort by file offset (the writer lays groups out
        sequentially, so offset order tracks task order). Extents merge while
        the hole is within the shard's coalesce gap, the run stays under
        ``max_run_bytes``, and the run spans at most ``io_depth`` tasks —
        the last cap is what keeps prefetch buffering bounded. Remote shards
        halve that span cap so at least two runs fit the admission window at
        once: the async batcher can only overlap ranges that are admissible
        together.
        Returns ``[(shard, off, end, [(page_off, size, page, task_idx)],
        min_task, max_task)]``.
        """
        runs = []
        i = 0
        while i < len(self._tasks):
            shard = self._tasks[i].shard
            gap = self._source.shard_coalesce_gap(shard)
            span_cap = self._depth
            if _backend.is_remote(self._source.paths[shard]):
                span_cap = max(1, self._depth // 2)
            seg: list[tuple[int, int, int, int]] = []
            j = i
            fv = self._source.footer(shard)
            while j < len(self._tasks) and self._tasks[j].shard == shard:
                for p in eager[j]:
                    off, size = fv.page_extent(p)
                    seg.append((off, size, p, j))
                j += 1
            seg.sort()
            k = 0
            while k < len(seg):
                off, size, _, t = seg[k]
                end = off + size
                lo_t = hi_t = t
                m = k + 1
                while m < len(seg):
                    o2, s2, _, t2 = seg[m]
                    if o2 - end > gap:
                        break
                    if max(end, o2 + s2) - off > self._max_run_bytes:
                        break
                    if max(hi_t, t2) - min(lo_t, t2) + 1 > span_cap:
                        break
                    end = max(end, o2 + s2)
                    lo_t, hi_t = min(lo_t, t2), max(hi_t, t2)
                    m += 1
                runs.append((shard, off, end,
                             [(o, s, p, ti) for o, s, p, ti in seg[k:m]],
                             lo_t, hi_t))
                k = m
            i = j
        # issue order must follow *task* order, not raw file offset: a
        # relocated page (compliance deletes append rebuilt pages at the
        # file tail) can put an early task's bytes after a later task's,
        # and a window blocked on the later run would deadlock against a
        # consumer waiting for the earlier task. Sorting by (first task,
        # offset) keeps every run an awaited task needs admissible.
        runs.sort(key=lambda r: (r[4], r[1]))
        return runs

    # -- lifecycle --------------------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._io_loop, daemon=True,
                name="bullion-io-scheduler")
            self._thread.start()

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- executor side ----------------------------------------------------------
    def reader_for(self, i: int):
        """Reader for task index ``i``: blocks until its eager pages are
        staged (the request also advances the prefetch window), then returns
        a ``PrefetchReader`` over them — or the plain shared reader when
        there is nothing staged (empty eager set, scheduler error/stop).
        Time the executor spends blocked here is the pipeline's exposed
        (un-overlapped) I/O — the ``io.stage_wait`` span."""
        base = self._source.reader(self._tasks[i].shard)
        sp = _trace.span("io.stage_wait", cat="io", task=i)
        with sp, self._cond:
            if i > self._max_requested:
                self._max_requested = i
                self._cond.notify_all()
            while i not in self._done and self._error is None \
                    and not self._stop:
                self._cond.wait()
            pages = self._buffers.pop(i, None)
            if sp.enabled:
                sp.set(staged_pages=len(pages) if pages else 0)
        if pages:
            return PrefetchReader(base, pages)
        return base

    # -- scheduler thread -------------------------------------------------------
    def _io_loop(self) -> None:
        try:
            runs = self._runs
            i = 0
            while i < len(runs):
                shard, max_task = runs[i][0], runs[i][5]
                # admit on the run's *highest* task so no staged page is
                # ever more than io_depth - 1 tasks past the newest request
                wait_sp = _trace.span("io.queue_wait", cat="io",
                                      task=max_task)
                with wait_sp, self._cond:
                    while not self._stop and \
                            max_task > self._max_requested + self._depth - 1:
                        self._cond.wait()
                    if self._stop:
                        return
                    # how far the submission runs ahead of decode (window
                    # occupancy, in tasks) — the scheduler's queue depth
                    _metrics.histogram("bullion.io.read_ahead_tasks") \
                        .observe(max(0, max_task - self._max_requested))
                    # every already-admissible same-shard run joins this
                    # submission. Local runs extend on the same strict bound
                    # they were admitted on (and are fetched serially, so
                    # batching changes nothing); remote runs extend when the
                    # run *starts* inside the window — staging may then reach
                    # ~1.5x io_depth tasks ahead, the price of having >= 2
                    # ranges in flight for the async batcher to overlap.
                    remote = _backend.is_remote(self._source.paths[shard])
                    adm = 4 if remote else 5
                    j = i + 1
                    while j < len(runs) and runs[j][0] == shard and \
                            runs[j][adm] <= self._max_requested \
                            + self._depth - 1:
                        j += 1
                reader = self._source.reader(shard)
                batch = runs[i:j]
                for k, pages, err in reader._fetch_runs(
                        [(off, end, [(o, s, p) for o, s, p, _ in ext])
                         for _, off, end, ext, _, _ in batch],
                        max_in_flight=self._depth,
                        span_meta=[{"shard": shard, "task": r[5]}
                                   for r in batch]):
                    extents = batch[k][3]
                    with self._cond:
                        if self._stop:
                            # closing the generator cancels any still-queued
                            # remote ranges in the batch
                            return
                        if err is not None:
                            # fail only the tasks this run covered: dropping
                            # their buffers makes reader_for() return the
                            # direct-read path, which retries serially and
                            # surfaces the real error to exactly those tasks
                            for _, _, _, t in extents:
                                self._buffers.pop(t, None)
                                self._done.add(t)
                        else:
                            for _, _, p, t in extents:
                                buf = self._buffers.get(t)
                                if buf is not None:
                                    buf[p] = pages[p]
                                self._left[t] -= 1
                                if self._left[t] == 0:
                                    self._done.add(t)
                        self._cond.notify_all()
                i = j
        except BaseException as e:
            # fail open: pending reader_for() calls fall back to the shared
            # reader's direct path, which surfaces any real I/O error itself
            with self._cond:
                self._error = e
                self._cond.notify_all()
