"""The port's deletion compliance (``core/deletion.py``, ``Dataset.delete_where``)
on the CPU, held against the JAX package's ``repro.core.deletion``.

Each table is written from one seed by each package's own writer (the files
are byte-identical, ``tests/test_torch_storage.py``). Then the same deletes
run in both packages, one step at a time, and after every step the files
must be byte-identical, ``DeleteStats`` and ``verify_deleted`` equal, and a
file deleted by either package must read the same in the other.

Tolerance: none. Bytes, row ids and values are compared exactly.
"""

import dataclasses
import os

import numpy as np
import pytest

import repro.core as ref_core
import repro.data.synthetic as ref_synthetic
import repro.dataset as ref_dataset
import repro.scan as ref_scan
import repro_torch.core as core
import repro_torch.data as synthetic
import repro_torch.scan as scan
from repro_torch.dataset import dataset

# float16 casts in the quantized table warn in both packages
pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

TABLES = {
    # the ads fixture of tests/test_deletion.py: 4096 rows, 512 a group
    "ads": ("write_ads_table", dict(n_rows=4096, n_sparse=4, n_dense=4,
                                    seq_len=16, rows_per_group=512)),
    "lm": ("write_lm_corpus", dict(n_docs=256, vocab=128, doc_len=64,
                                   rows_per_group=32)),
    # shards of a directory: one click-sequence column (re-encoding those
    # lists is most of a delete's time)
    "ads_shard": ("write_ads_table", dict(n_rows=2048, n_sparse=1, n_dense=4,
                                          seq_len=16, rows_per_group=512)),
}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each table written once a module by each package's writer (files
    byte-identical); tests take copies."""
    root = tmp_path_factory.mktemp("tables")
    out = {}
    for table, seed in (("ads", 0), ("lm", 0), ("ads_shard", 0),
                        ("ads_shard", 1)):
        fn, kw = TABLES[table]
        pair = []
        for pkg, sub in ((synthetic, "port"), (ref_synthetic, "ref")):
            path = root / sub / f"{table}-{seed}.bln"
            path.parent.mkdir(exist_ok=True)
            getattr(pkg, fn)(str(path), seed=seed, **kw)
            pair.append(path.read_bytes())
        assert pair[0] == pair[1]
        out[table, seed] = pair[0]
    return out


def _write_pair(tmp_path, written, table, seed=0, name=None):
    """Copies of one table for each package; (port path, ref path)."""
    name = name or f"{table}.bln"
    paths = []
    for sub in ("port", "ref"):
        (tmp_path / sub).mkdir(exist_ok=True)
        path = tmp_path / sub / name
        path.write_bytes(written[table, seed])
        paths.append(str(path))
    return tuple(paths)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_tables(a, b):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8))
        else:
            assert len(a[k]) == len(b[k])
            assert all(np.array_equal(np.asarray(x), np.asarray(y))
                       for x, y in zip(a[k], b[k]))


def _read(open_fn, path, drop):
    """Every column and the row ids of a file, or the type and text of
    what the read raised."""
    try:
        with open_fn(path).drop_deleted(drop) as ds:
            return ds.to_table(), ds.row_ids()
    except (AssertionError, ValueError) as e:
        return type(e).__name__, str(e)


def _cross_read(port_path, ref_path):
    """Every column, visible and raw rows, read by each package from the
    other's file, equal to the other's own read (or raising alike)."""
    for drop in (True, False):
        mine = _read(lambda p: dataset(p, device="cpu"), ref_path, drop)
        theirs = _read(ref_dataset.dataset, port_path, drop)
        if isinstance(mine[0], str):
            assert mine == theirs
            continue
        _same_tables(mine[0], theirs[0])
        assert np.array_equal(mine[1], theirs[1])


def _victim_steps(kind, uid, n):
    """Row-id sets, one a delete step."""
    rng = np.random.default_rng(7)
    if kind == "users":                      # per-user erasure, stacked
        return [np.flatnonzero(uid == v) for v in np.unique(uid)[[0, 5, 9]]]
    if kind == "overlap":                    # the same page hit twice
        return [np.arange(10, 20), np.arange(15, 30)]
    if kind == "scattered":
        a = np.sort(rng.choice(n, n // 256, replace=False))
        b = np.sort(rng.choice(n, n // 256, replace=False))
        return [a, b]
    if kind == "whole_group":                # every row of one group, then
        return [np.arange(n // 8, n // 4), np.arange(0, n // 8, 3)]
    raise ValueError(kind)


@pytest.mark.parametrize("table,audit_col", [("ads", "user_id"),
                                             ("lm", "doc_id")])
@pytest.mark.parametrize("kind", ["users", "overlap", "scattered",
                                  "whole_group"])
@pytest.mark.parametrize("levels", [(2, 2), (1, 1), (1, 2), (2, 1)])
def test_delete_rows_matches_reference(tmp_path, written, table, audit_col,
                                       kind, levels):
    port_path, ref_path = _write_pair(tmp_path, written, table)
    with ref_dataset.dataset(ref_path) as rds:
        ids = rds.select([audit_col]).to_table()[audit_col]
    steps = _victim_steps(kind, ids, len(ids))
    for step, rows in enumerate(steps):
        level = levels[min(step, len(levels) - 1)]
        got = core.delete_rows(port_path, rows, core.Compliance(level))
        want = ref_core.delete_rows(ref_path, rows,
                                    ref_core.Compliance(level))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), step
        assert _bytes(port_path) == _bytes(ref_path), step
        victims = ids[rows]
        audit = _outcome(core.verify_deleted, port_path, audit_col, victims,
                         device="cpu")
        assert audit == _outcome(ref_core.verify_deleted, ref_path,
                                 audit_col, victims)
    # L1 after L2 on a compacted page breaks the decoded-length invariant
    # in both packages (ROADMAP.md §3): their reads raise alike
    assert isinstance(audit, dict) or levels == (2, 1)
    _cross_read(port_path, ref_path)


def _outcome(fn, *args, **kw):
    """fn's result, or the type and text of what it raised."""
    try:
        return fn(*args, **kw)
    except (AssertionError, ValueError) as e:
        return type(e).__name__, str(e)


def test_level2_erases_and_level1_keeps(tmp_path, written):
    """The audit's two answers on the port's own deletes: L2 leaves no raw
    occurrence and rewrites less than half the file; L1 keeps every raw
    occurrence, hides them all and rewrites no page."""
    port_path, ref_path = _write_pair(tmp_path, written, "ads")
    with dataset(port_path, device="cpu") as ds:
        uid = ds.select(["user_id"]).to_table()["user_id"]
    victims = np.unique(uid)[:3]
    rows = np.flatnonzero(np.isin(uid, victims))
    st = core.delete_rows(port_path, rows, core.Compliance.LEVEL2)
    assert st.rows_deleted == len(rows)
    assert st.pages_masked_in_place + st.pages_relocated > 0
    assert st.bytes_rewritten < st.bytes_full_rewrite / 2
    assert st.hash_ops_incremental < st.hash_ops_monolithic * 2
    assert core.verify_deleted(port_path, "user_id", victims,
                               device="cpu") == \
        {"visible_rows": 0, "raw_occurrences": 0}
    with dataset(port_path, device="cpu") as ds:
        assert ds.count_rows() == len(uid) - len(rows)
    # L1 on another copy (the reference package's file: the same bytes)
    st1 = core.delete_rows(ref_path, rows, core.Compliance.LEVEL1)
    assert st1.pages_dv_only == st1.pages_touched > 0
    assert st1.bytes_rewritten_data == 0
    assert core.verify_deleted(ref_path, "user_id", victims, device="cpu") == \
        {"visible_rows": 0, "raw_occurrences": len(rows)}
    with dataset(ref_path, device="cpu") as ds:
        assert ds.count_rows() == len(uid) - len(rows)


def test_level0_is_refused_like_the_reference(tmp_path, written):
    port_path, ref_path = _write_pair(tmp_path, written, "ads")
    before = _bytes(port_path)
    with pytest.raises(ValueError, match="LEVEL0") as got:
        core.delete_rows(port_path, np.arange(4), core.Compliance.LEVEL0)
    with pytest.raises(ValueError, match="LEVEL0") as want:
        ref_core.delete_rows(ref_path, np.arange(4),
                             ref_core.Compliance.LEVEL0)
    assert str(got.value) == str(want.value)
    assert _bytes(port_path) == before


def _predicates(pkg):
    C, In = pkg.C, pkg.In
    return {
        # float32 range over two dense features: the range filter's route
        "dense_range": (C("dense_0") > 2.0) & (C("dense_1") <= 0.0),
        "user_eq": C("user_id") == 37,
        "user_in": In("user_id", [3, 64, 65, 200, 511]),
        "none": C("user_id") == 10**9,
    }


@pytest.mark.parametrize("pred", ["dense_range", "user_eq", "user_in",
                                  "none"])
@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("shards", [1, 2])
def test_delete_where_matches_reference(tmp_path, written, pred, level,
                                       shards):
    """``delete_where`` over one file and over a directory of shards (global
    row ids translated to each shard's local rows)."""
    table = "ads" if shards == 1 else "ads_shard"
    pairs = [_write_pair(tmp_path, written, table, seed=s,
                         name=f"part-{s:04d}.bln")
             for s in range(shards)]
    where = (lambda i: pairs[0][i]) if shards == 1 else \
        (lambda i: os.path.dirname(pairs[0][i]))
    got = core.delete_where(where(0), _predicates(scan)[pred],
                            core.Compliance(level), device="cpu")
    want = ref_core.delete_where(where(1), _predicates(ref_scan)[pred],
                                 ref_core.Compliance(level))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.rows_deleted == 0) == (pred == "none")
    for port_path, ref_path in pairs:
        assert _bytes(port_path) == _bytes(ref_path)
    with dataset(where(0), device="cpu") as ds:
        assert ds.where(_predicates(scan)[pred]).count_rows() == 0
    _cross_read(where(0), where(1))


def test_dataset_delete_where_goes_stale_like_the_reference(tmp_path,
                                                          written):
    port_path, ref_path = _write_pair(tmp_path, written, "ads")
    ds = dataset(port_path, device="cpu")
    rds = ref_dataset.dataset(ref_path)
    st = ds.delete_where(scan.C("user_id") < 5)
    assert st.rows_deleted == rds.delete_where(ref_scan.C("user_id") < 5) \
        .rows_deleted > 0
    with pytest.raises(ValueError, match="stale"):
        ds.count_rows()
    with pytest.raises(ValueError, match="stale"):
        rds.count_rows()
    # a delete that matches nothing leaves the dataset usable
    ds2 = dataset(port_path, device="cpu")
    assert ds2.delete_where(scan.C("user_id") == 10**9).rows_deleted == 0
    assert ds2.count_rows() == 4096 - st.rows_deleted
    ds2.close()
    assert _bytes(port_path) == _bytes(ref_path)


def test_delete_where_locates_on_the_dataset_device(tmp_path, written,
                                                   monkeypatch):
    """A float32 range predicate locates its victims through the range
    filter on the dataset's device: once a row group evaluated."""
    import repro_torch.kernels.filter as kfilter
    port_path, _ = _write_pair(tmp_path, written, "ads")
    calls = []
    real = kfilter.range_mask

    def spy(cols, lo, hi, *, device=None):
        calls.append((tuple(cols.shape), str(device)))
        return real(cols, lo, hi, device=device)

    monkeypatch.setattr(kfilter, "range_mask", spy)
    pred = _predicates(scan)["dense_range"]
    with dataset(port_path, device="cpu") as ds:
        groups = len(ds.where(pred).drop_deleted(False).tasks())
    calls.clear()
    core.delete_where(port_path, pred, device="cpu")
    assert groups > 0 and len(calls) == groups
    assert all(shape[0] == 2 and dev == "cpu" for shape, dev in calls)
