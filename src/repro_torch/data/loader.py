"""Bullion-backed training input pipeline.

The loader is a streaming adapter over the lazy ``Dataset`` plan path: the
plan (projection to the token column, optional quality predicate) is built
and lowered once at construction — zone-map pruning decides the surviving
row groups up front — and each group is then read through the same
prune -> pread -> decode -> deletion-mask -> dequantize -> filter pipeline
every other surface uses. Work is split across data-parallel ranks by
*shard* when the dataset has at least one file per rank — each rank then
reads disjoint files, so distributed training never contends on a handle or
an OS page-cache line — and by row group otherwise (single-file datasets, or
fewer shards than ranks). Either way ranks see disjoint, contiguous ranges;
the quality-presorted layout keeps each rank's reads sequential. Host decode
overlaps device compute via a prefetch thread, ``prefetch=`` additionally
drives the pipelined I/O scheduler (``dataset.io``) so the next groups'
coalesced preads overlap the current group's decode, and the cursor (epoch,
group index) is checkpointable for exactly-once resume.

``device`` is where the plan's range filter (and any dequantize) runs: the
default ``cuda`` raises where CUDA is absent unless given ``"cpu"``. The
prefetch thread launches those kernels, so they run on a thread other than
the caller's; the kernels' wrappers serialise their launches. Batches are
NumPy ``int32`` arrays on the host, as the reference yields them.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..dataset import dataset
from ..obs import metrics as _metrics
from ..obs import trace as _trace


@dataclass
class LoaderState:
    epoch: int = 0
    group: int = 0          # next row group (global index) to read


class BullionLoader:
    def __init__(self, path: str, *, batch_size: int, seq_len: int,
                 rank: int = 0, world: int = 1, prefetch: int = 2,
                 column: str = "tokens", seed: int = 0,
                 state: Optional[LoaderState] = None,
                 predicate=None, device=None):
        self.path = path
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.rank, self.world = rank, world
        self.column = column
        # batches-ahead bound for the consumer queue AND the read-ahead
        # depth of the I/O scheduler (prefetch > 1 pipelines preads)
        self.prefetch = max(1, int(prefetch))
        self.state = state or LoaderState()
        self.dataset = dataset(path, device=device).select([column])
        if predicate is not None:
            self.dataset = self.dataset.where(predicate)
        # planning is static per dataset: lower once (zone-map pruning picks
        # the surviving groups and credits pruned bytes), stream forever.
        # Groups are scheduled by *global* group index — shard-local index
        # offset by the groups of preceding shards — so a directory/glob
        # dataset streams every shard and a one-file cursor keeps the seed
        # checkpoint semantics (global index == file group index).
        src = self.dataset._source
        group_off = [0]
        for s in range(src.n_shards):
            group_off.append(group_off[-1] + src.footer(s).n_groups)
        self.n_groups = group_off[-1]
        self._tasks = {group_off[t.shard] + t.group: t
                       for t in self.dataset.tasks()}
        self._groups = sorted(self._tasks)
        # rank striping: across whole shards when every rank can own at
        # least one *surviving* file (disjoint handles, no shared page-cache
        # lines); across row groups otherwise (single file, fewer shards
        # than ranks, or zone-map pruning emptied too many shards — a rank
        # must never starve while others read). Shards are assigned by
        # position in the sorted surviving-shard list, which is identical on
        # every rank (same plan) and static across epochs and resumes.
        live = sorted({t.shard for t in self._tasks.values()})
        self._shard_rank = {s: i % world for i, s in enumerate(live)}
        self._stripe_shards = world > 1 and len(live) >= world
        self._tokens_per_batch = batch_size * (seq_len + 1)
        self._buf = np.zeros(0, np.int32)
        self._queue: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- group scheduling --------------------------------------------------------
    def _my_groups(self, epoch: int) -> list[int]:
        if self._stripe_shards:
            return [g for g in self._groups
                    if self._shard_rank[self._tasks[g].shard] == self.rank]
        return [g for i, g in enumerate(self._groups)
                if i % self.world == self.rank]

    def _make_scheduler(self, groups: list[int]):
        """Pipelined I/O over this rank's remaining groups for one epoch
        pass: the scheduler stages the next ``prefetch`` groups' coalesced
        preads while the current group decodes. None = serial reads."""
        if self.prefetch <= 1 or len(groups) <= 1:
            return None
        from ..dataset.io import IOScheduler
        opt = self.dataset.plan()
        cols = opt.prefetch_columns()
        if not cols:
            return None
        sched = IOScheduler(self.dataset._source,
                            [self._tasks[g] for g in groups],
                            columns=cols, io_depth=self.prefetch)
        sched.start()
        return sched

    def _read_group(self, g: int, reader=None) -> np.ndarray:
        task = self._tasks[g]
        sp = _trace.span("loader.read_group", cat="loader",
                         shard=task.shard, group=task.group, rank=self.rank)
        with sp:
            tbl = self.dataset.read_group(task.group, shard=task.shard,
                                          reader=reader)
            docs = tbl[self.column] if tbl is not None else []
            if len(docs) == 0:
                return np.zeros(0, np.int32)
            out = np.concatenate([np.asarray(d, np.int32) for d in docs]) \
                if isinstance(docs, list) else np.asarray(docs, np.int32)
            if sp.enabled:
                sp.set(tokens=int(len(out)))
            return out

    # -- iteration ------------------------------------------------------------------
    def _put(self, item) -> bool:
        """Bounded put that never deadlocks against close(): re-checks the
        stop flag instead of blocking forever on a full queue."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            while not self._stop.is_set():
                # resume skips already-consumed groups; the scheduler is
                # built over exactly the remaining ones, in read order
                mine = [g for g in self._my_groups(self.state.epoch)
                        if g >= self.state.group]
                sched = self._make_scheduler(mine)
                try:
                    for i, g in enumerate(mine):
                        reader = sched.reader_for(i) if sched is not None \
                            else None
                        self._buf = np.concatenate(
                            [self._buf, self._read_group(g, reader)])
                        while len(self._buf) >= self._tokens_per_batch:
                            # batch assembly: slice + reshape + copy out of
                            # the token buffer (the host-side cost between
                            # decode and the consumer queue)
                            with _trace.span("loader.batch", cat="loader",
                                             rank=self.rank,
                                             tokens=self._tokens_per_batch):
                                batch = self._buf[:self._tokens_per_batch] \
                                    .reshape(self.batch_size,
                                             self.seq_len + 1)
                                self._buf = \
                                    self._buf[self._tokens_per_batch:]
                                cursor = LoaderState(self.state.epoch, g + 1)
                                item = (batch.copy(), cursor)
                            _metrics.histogram(
                                "bullion.loader.queue_depth") \
                                .observe(self._queue.qsize())
                            if not self._put(item):
                                return
                        self.state.group = g + 1
                finally:
                    if sched is not None:
                        sched.close()
                self.state.epoch += 1
                self.state.group = 0
        except Exception as e:  # surface in consumer
            self._put(e)

    def __iter__(self) -> Iterator[tuple[np.ndarray, LoaderState]]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._produce, daemon=True)
            self._thread.start()
        while True:
            item = self._queue.get()
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        # Order matters: signal stop first, then drain while joining — the
        # producer only blocks in bounded 0.1 s put() attempts, so draining
        # plus a timed join always converges (no full-queue deadlock).
        self._stop.set()
        if self._thread is not None:
            deadline = 20.0
            while self._thread.is_alive() and deadline > 0:
                try:
                    while True:
                        self._queue.get_nowait()
                except queue.Empty:
                    pass
                self._thread.join(timeout=0.2)
                deadline -= 0.2
            self._thread = None
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self.dataset.close()
