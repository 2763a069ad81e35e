"""The port's training-data reads on the CPU: ``data/loader.py``
(``BullionLoader``, ``LoaderState``) and ``core/multimodal.py``
(``write_multimodal_dataset``, ``quality_filtered_read``, ``MediaStore``),
held against the JAX package's ``repro.data.loader`` and
``repro.core.multimodal``.

Inputs are written from one seed by each package's own writer (the files are
byte-identical). Tolerance: none. Batches, cursors, rows and I/O counters
are compared exactly (``IOStats.metadata_seconds``, a time, left out).
"""

import dataclasses
import os
import threading

import numpy as np
import pytest

import repro.core as ref_core
import repro.data.synthetic as ref_synthetic
from repro.data.loader import BullionLoader as RefLoader
from repro.data.loader import LoaderState as RefState
from repro.scan import C as RC
import repro_torch.core as core
import repro_torch.data as synthetic
from repro_torch.data import BullionLoader, LoaderState
from repro_torch.dataset import dataset
from repro_torch.scan import C

CORPUS = dict(n_docs=32, vocab=128, doc_len=128, rows_per_group=4)


def _pair(tmp_path, seeds=(0,), name="corpus"):
    """One corpus (or a directory of shards, one a seed) written by each
    package; (port path, ref path)."""
    out = []
    for pkg, sub in ((synthetic, "port"), (ref_synthetic, "ref")):
        d = tmp_path / sub
        d.mkdir(exist_ok=True)
        for s in seeds:
            pkg.write_lm_corpus(str(d / f"{name}-{s}.bln"), seed=s, **CORPUS)
        out.append(str(d / f"{name}-{seeds[0]}.bln") if len(seeds) == 1
                   else str(d))
    for s in seeds:
        assert (tmp_path / "port" / f"{name}-{s}.bln").read_bytes() == \
            (tmp_path / "ref" / f"{name}-{s}.bln").read_bytes()
    return tuple(out)


def _take(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        loader.close()


def _same_stream(got, want):
    assert len(got) == len(want)
    for (b, c), (rb, rc) in zip(got, want):
        assert b.dtype == rb.dtype == np.int32
        assert np.array_equal(b, rb)
        assert dataclasses.asdict(c) == dataclasses.asdict(rc)


@pytest.mark.parametrize("predicate", [False, True])
@pytest.mark.parametrize("world,rank", [(1, 0), (2, 0), (2, 1), (3, 2)])
@pytest.mark.parametrize("prefetch", [1, 2])
def test_batches_match_reference(tmp_path, predicate, world, rank, prefetch):
    """One file: ranks stripe over row groups. 40 batches cross an epoch
    boundary, so the wrap and the cursor's reset are compared too."""
    path, ref_path = _pair(tmp_path)
    kw = dict(batch_size=2, seq_len=64, rank=rank, world=world,
              prefetch=prefetch)
    got = _take(BullionLoader(path, device="cpu",
                              predicate=(C("quality") >= 0.5) if predicate
                              else None, **kw), 40)
    want = _take(RefLoader(ref_path, predicate=(RC("quality") >= 0.5)
                           if predicate else None, **kw), 40)
    _same_stream(got, want)
    assert max(c.epoch for _, c in got) >= 1


@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (4, 3)])
def test_shard_striping_matches_reference(tmp_path, world, rank):
    """A directory of 3 shards: whole shards a rank when every rank can own
    one (world 2), row groups otherwise (world 4)."""
    d, ref_d = _pair(tmp_path, seeds=(0, 1, 2))
    kw = dict(batch_size=2, seq_len=64, rank=rank, world=world, prefetch=2)
    loader = BullionLoader(d, device="cpu", **kw)
    ref = RefLoader(ref_d, **kw)
    assert loader._stripe_shards == ref._stripe_shards == (world == 2)
    _same_stream(_take(loader, 30), _take(ref, 30))


@pytest.mark.parametrize("at", [0, 3, 9])
def test_resume_matches_reference(tmp_path, at):
    path, ref_path = _pair(tmp_path)
    kw = dict(batch_size=2, seq_len=64, predicate=None)
    first = _take(BullionLoader(path, device="cpu", **kw), at + 1)
    cur = first[at][1]
    got = _take(BullionLoader(path, device="cpu",
                              state=LoaderState(cur.epoch, cur.group), **kw),
                8)
    want = _take(RefLoader(ref_path, state=RefState(cur.epoch, cur.group),
                           **kw), 8)
    _same_stream(got, want)
    # the resumed stream restarts at the cursor's group boundary
    with dataset(path, device="cpu") as ds:
        docs = ds.select(["tokens"]).to_table()["tokens"]
    per_group = CORPUS["rows_per_group"]
    stream = np.concatenate([np.asarray(x, np.int32)
                             for x in docs[cur.group * per_group:]])
    assert np.array_equal(got[0][0], stream[:2 * 65].reshape(2, 65))


def test_loader_thread_and_a_main_thread_scan(tmp_path, monkeypatch):
    """The loader's prefetch thread evaluates its predicate while the main
    thread scans the same file: both see the reference's rows, and the
    filter is called once a group each reader evaluated, from the thread
    that read the group."""
    import repro_torch.kernels.filter as kfilter
    path, ref_path = _pair(tmp_path)
    calls, lock = [], threading.Lock()
    real = kfilter.range_mask

    def spy(cols, lo, hi, *, device=None):
        with lock:
            calls.append(threading.current_thread().name)
        return real(cols, lo, hi, device=device)

    monkeypatch.setattr(kfilter, "range_mask", spy)
    pred, kw = C("quality") >= 0.5, dict(batch_size=2, seq_len=64)
    loader = BullionLoader(path, device="cpu", predicate=pred, prefetch=2,
                           **kw)
    reads, read_group = [], loader._read_group

    def counted(g, reader=None):
        reads.append(g)
        return read_group(g, reader)

    loader._read_group = counted
    it = iter(loader)
    got = [next(it)]
    scans = []
    with dataset(path, device="cpu").where(pred) as ds:
        scan_groups = len(ds.tasks())
        for _ in range(3):
            scans.append(ds.to_table())
    got += [next(it) for _ in range(5)]
    loader.close()
    main = threading.current_thread().name
    assert calls.count(main) == 3 * scan_groups
    assert len(calls) - calls.count(main) == len(reads) > 0
    _same_stream(got, _take(RefLoader(ref_path, predicate=RC("quality") >= 0.5,
                                      prefetch=2, **kw), 6))
    for t in scans[1:]:
        assert np.array_equal(t["doc_id"], scans[0]["doc_id"])


def test_close_stops_the_thread(tmp_path):
    path, _ = _pair(tmp_path)
    loader = BullionLoader(path, device="cpu", batch_size=2, seq_len=64)
    it = iter(loader)
    next(it)
    thread = loader._thread
    loader.close()
    assert thread is not None and not thread.is_alive()


def _samples(pkg, n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return [pkg.MultimodalSample(
        text=b"t%d" % i, quality=float(rng.random()),
        embedding=rng.normal(size=8).astype(np.float32),
        frames=bytes([i % 256] * 16), media_key=i) for i in range(n)]


@pytest.fixture
def multimodal(tmp_path):
    paths = {}
    for pkg, sub in ((core, "port"), (ref_core, "ref")):
        d = tmp_path / sub
        d.mkdir()
        meta, media = str(d / "m.bln"), str(d / "m.media")
        stats = pkg.write_multimodal_dataset(meta, media, _samples(pkg),
                                             rows_per_group=100)
        paths[sub] = (meta, media, stats)
    return paths


def test_write_multimodal_dataset_matches_reference(multimodal):
    (meta, media, stats), (rmeta, rmedia, rstats) = \
        multimodal["port"], multimodal["ref"]
    assert stats == rstats
    assert open(meta, "rb").read() == open(rmeta, "rb").read()
    assert open(media, "rb").read() == open(rmedia, "rb").read()
    keys = [5, 0, 999, 123]
    assert core.MediaStore(media).read(keys) == \
        ref_core.MediaStore(rmedia).read(keys)


def _io(stats):
    d = dataclasses.asdict(stats)
    d.pop("metadata_seconds")
    return d


@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.35, 1.0])
@pytest.mark.parametrize("columns", [["quality"],
                                     ["text", "quality", "embedding",
                                      "media_key"]])
def test_quality_filtered_read_matches_reference(multimodal, fraction,
                                                 columns):
    meta, rmeta = multimodal["port"][0], multimodal["ref"][0]
    tables, stats = core.quality_filtered_read(meta, columns, fraction,
                                               device="cpu")
    rtables, rstats = ref_core.quality_filtered_read(rmeta, columns, fraction)
    assert len(tables) == len(rtables)
    for t, rt in zip(tables, rtables):
        assert list(t) == list(rt)
        for k in t:
            if isinstance(t[k], np.ndarray):
                assert t[k].dtype == rt[k].dtype
                assert np.array_equal(t[k], rt[k])
            else:
                assert len(t[k]) == len(rt[k])
                assert all(np.array_equal(np.asarray(a), np.asarray(b))
                           for a, b in zip(t[k], rt[k]))
    assert _io(stats) == _io(rstats)
    q = np.concatenate([t["quality"] for t in tables])
    assert len(q) == int(1000 * fraction)
    assert np.all(np.diff(q) <= 0)          # presorted by quality
    if 0 < fraction < 1:
        assert stats.bytes_pruned > 0       # trailing groups never read
    assert os.path.exists(meta)
