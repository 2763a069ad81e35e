"""The port's write sink (``dataset/sink.py``, ``Dataset.write_to``) on the
CPU, held against the JAX package's ``repro.dataset.sink``.

The input is written from one seed by each package's own writer (the files
are byte-identical). The same plan is then materialized by both packages;
each output shard must be byte-identical to the reference's, the
``WriteResult`` equal (paths compared by name), and the shards must read
back equal in both packages.

Tolerance: none. Bytes and values are compared exactly.
"""

import dataclasses
import os

import numpy as np
import pytest

import repro.core as ref_core
import repro.dataset as ref_dataset
import repro.scan as ref_scan
import repro_torch.core as core
import repro_torch.scan as scan
from repro_torch.dataset import dataset

N = 2000


def _write(pkg, path, *, n=N, rows_per_group=250, seed=0):
    """The table of tests/test_sink.py, plus an INT8-affine column."""
    rng = np.random.default_rng(seed)
    score = rng.random(n).astype(np.float32)
    schema = [
        pkg.ColumnSpec("id", "int64"),
        pkg.ColumnSpec("score", "float32"),
        pkg.ColumnSpec("qx", "float32", quant=pkg.QuantSpec(pkg.QuantMode.BF16)),
        pkg.ColumnSpec("qa", "float32", quant=pkg.affine_spec_for(
            score * 4 - 2, pkg.QuantMode.INT8_AFFINE)),
        pkg.ColumnSpec("tag", "string"),
        pkg.ColumnSpec("seq", "list<int64>"),
    ]
    table = {
        "id": rng.permutation(np.arange(n, dtype=np.int64)),
        "score": score,
        "qx": rng.normal(size=n).astype(np.float32),
        "qa": score * 4 - 2,
        "tag": [b"t%d" % (i % 7) for i in range(n)],
        "seq": [np.arange(i % 5, dtype=np.int64) for i in range(n)],
    }
    w = pkg.BullionWriter(path, schema, rows_per_group=rows_per_group)
    w.write_table(table)
    w.close()
    return table


@pytest.fixture
def pair(tmp_path):
    p, r = str(tmp_path / "in-port.bln"), str(tmp_path / "in-ref.bln")
    _write(core, p)
    _write(ref_core, r)
    assert open(p, "rb").read() == open(r, "rb").read()
    return p, r


def _plan(pkg, scan_pkg, ds, kind):
    C = scan_pkg.C
    return {
        "plain": ds,
        "select": ds.select(["id", "tag", "qa"]),
        "where_range": ds.where((C("score") > 0.2) & (C("qx") <= 1.0)),
        "where_id": ds.where(C("id") < 500),
        "raw": ds.dequantized(False),
        "head": ds.head(777),
        "empty": ds.where(C("id") == 10**9).select(["id", "tag"]),
    }[kind]


def _options(pkg, kind):
    return {
        "none": {},
        "sort_col": dict(sort_by="score"),
        "sort_udf": dict(sort_by=pkg.quality_sort("score")),
        "shards": dict(shard_rows=700),
        "pages": dict(page_rows=64, rows_per_group=500),
        "compliance_no_advisor": dict(compliance=2, use_advisor=False),
        "parallel": dict(parallelism=2, io_depth=2),
    }[kind]


def _result(res):
    d = dataclasses.asdict(res)
    d["paths"] = [os.path.basename(p) for p in d["paths"]]
    return d


def _same_outputs(out, ref_out, res, ref_res):
    assert _result(res) == _result(ref_res)
    for p, r in zip(res.paths, ref_res.paths):
        assert open(p, "rb").read() == open(r, "rb").read(), p
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref_out))
    with dataset(out, device="cpu") as ds, ref_dataset.dataset(ref_out) as rds:
        mine, theirs = ds.to_table(), rds.to_table()
    assert list(mine) == list(theirs)
    for k in mine:
        if isinstance(mine[k], np.ndarray):
            assert np.array_equal(mine[k].view(np.uint8),
                                  theirs[k].view(np.uint8)), k
        else:
            assert len(mine[k]) == len(theirs[k])
            assert all(np.array_equal(np.asarray(a), np.asarray(b))
                       for a, b in zip(mine[k], theirs[k])), k


@pytest.mark.parametrize("plan,options", [
    ("plain", "none"), ("plain", "sort_col"), ("plain", "sort_udf"),
    ("plain", "shards"), ("plain", "pages"), ("plain", "compliance_no_advisor"),
    ("plain", "parallel"), ("select", "shards"), ("where_range", "none"),
    ("where_range", "sort_col"), ("where_id", "pages"), ("raw", "none"),
    ("raw", "shards"), ("head", "shards"), ("empty", "none"),
])
def test_write_to_matches_reference(tmp_path, pair, plan, options):
    port_in, ref_in = pair
    out, ref_out = str(tmp_path / "out-port"), str(tmp_path / "out-ref")
    with dataset(port_in, device="cpu") as ds:
        res = _plan(core, scan, ds, plan).write_to(out,
                                                   **_options(core, options))
    with ref_dataset.dataset(ref_in) as rds:
        ref_res = _plan(ref_core, ref_scan, rds, plan).write_to(
            ref_out, **_options(ref_core, options))
    _same_outputs(out, ref_out, res, ref_res)
    if options == "sort_col":
        with dataset(out, device="cpu") as ds:
            got = ds.select(["score"]).to_table()["score"]
        assert np.array_equal(got, np.sort(got))


@pytest.mark.parametrize("level", [1, 2])
def test_write_to_purges_a_deleted_input_like_the_reference(tmp_path, pair,
                                                             level):
    """Deleted rows are physically absent from the sink's output: the audit
    finds no raw occurrence, even after an L1 delete that kept them."""
    port_in, ref_in = pair
    with dataset(port_in, device="cpu") as ds:
        ids = ds.select(["id"]).to_table()["id"]
    rows = np.flatnonzero(ids % 9 == 4)
    victims = ids[rows]
    core.delete_rows(port_in, rows, core.Compliance(level))
    ref_core.delete_rows(ref_in, rows, ref_core.Compliance(level))
    raw_in = core.verify_deleted(port_in, "id", victims, device="cpu")
    assert raw_in["visible_rows"] == 0
    assert (raw_in["raw_occurrences"] == len(rows)) == (level == 1)
    out, ref_out = str(tmp_path / "out-port"), str(tmp_path / "out-ref")
    with dataset(port_in, device="cpu") as ds:
        res = ds.write_to(out, shard_rows=600)
    with ref_dataset.dataset(ref_in) as rds:
        ref_res = rds.write_to(ref_out, shard_rows=600)
    _same_outputs(out, ref_out, res, ref_res)
    assert res.rows == N - len(rows)
    for p in res.paths:
        assert core.verify_deleted(p, "id", victims, device="cpu") == \
            {"visible_rows": 0, "raw_occurrences": 0}


def test_write_to_refuses_what_the_reference_refuses(tmp_path, pair):
    port_in, ref_in = pair
    for ds, out in ((dataset(port_in, device="cpu"), str(tmp_path / "a")),
                    (ref_dataset.dataset(ref_in), str(tmp_path / "b"))):
        with ds:
            with pytest.raises(ValueError, match="shard_rows"):
                ds.write_to(out, shard_rows=0)
            with pytest.raises(KeyError, match="sort_by"):
                ds.select(["id"]).write_to(out, sort_by="score")
            ds.write_to(out)
            with pytest.raises(FileExistsError, match="already holds"):
                ds.write_to(out)
    assert sorted(os.listdir(tmp_path / "a")) == \
        sorted(os.listdir(tmp_path / "b")) == ["part-00000.bln"]


def test_failed_write_to_leaves_nothing(tmp_path, pair, monkeypatch):
    """A rewrite that fails half way removes its shards, so a retry works."""
    from repro_torch.dataset import sink
    port_in, _ = pair
    out = str(tmp_path / "out")
    real = sink.BullionWriter.write_table
    calls = []

    def failing(self, table):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("disk full")
        return real(self, table)

    monkeypatch.setattr(sink.BullionWriter, "write_table", failing)
    with dataset(port_in, device="cpu") as ds:
        with pytest.raises(OSError, match="disk full"):
            ds.write_to(out, shard_rows=300)
    assert os.listdir(out) == []
    monkeypatch.setattr(sink.BullionWriter, "write_table", real)
    with dataset(port_in, device="cpu") as ds:
        assert ds.write_to(out, shard_rows=300).rows == N


def test_output_schema_matches_reference(pair):
    port_in, ref_in = pair
    from repro.dataset.sink import output_schema as ref_output_schema
    from repro_torch.dataset.sink import output_schema
    names = ["id", "score", "qx", "qa", "tag", "seq"]
    for dq in (True, False):
        with dataset(port_in, device="cpu") as ds, \
                ref_dataset.dataset(ref_in) as rds:
            got = output_schema(ds._source, names, dq)
            want = ref_output_schema(rds._source, names, dq)
        assert [(s.name, s.dtype, s.sparse_delta) for s in got] == \
            [(s.name, s.dtype, s.sparse_delta) for s in want]
        assert [(int(s.quant.mode), s.quant.scale, s.quant.zero)
                for s in got] == [(int(s.quant.mode), s.quant.scale,
                                   s.quant.zero) for s in want]
