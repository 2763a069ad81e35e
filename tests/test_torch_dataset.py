"""The port's predicate read path, ``dataset(p, device="cpu")``, held against
the JAX package's ``repro.dataset.dataset(p)`` on the same files.

Tolerance: none. Row ids and every column are compared exactly, for each
filter route (``use_kernel`` None, True, False). The data hold no subnormal
values, where the reference's kernel route differs (see
``tests/test_torch_filter.py``).
"""

import numpy as np
import pytest

import repro.core as ref_core
import repro.data.synthetic as ref_synthetic
import repro.dataset as ref_dataset
import repro.scan as ref_scan
import repro_torch.data as synthetic
from repro_torch import dataset as port_dataset
from repro_torch import scan
from repro_torch.dataset import dataset

KERNEL_ROUTES = [None, True, False]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dataset")
    lm, ads = str(d / "lm.bln"), str(d / "ads.bln")
    synthetic.write_lm_corpus(lm, n_docs=256, doc_len=64, rows_per_group=32)
    synthetic.write_ads_table(ads, n_rows=4096, n_sparse=1, n_dense=4,
                              seq_len=8, rows_per_group=1024)
    deleted = str(d / "deleted.bln")
    ref_synthetic.write_ads_table(deleted, n_rows=4096, n_sparse=1, n_dense=4,
                                  seq_len=8, rows_per_group=1024)
    rng = np.random.default_rng(0)
    ref_core.delete_rows(deleted, np.sort(rng.choice(4096, 300, replace=False)))
    return {"lm": lm, "ads": ads, "deleted": deleted}


def _pred(mod, kind):
    C = mod.C
    return {
        "quality": C("quality") >= 0.5,
        "ads_ranges": (C("dense_0") > 0) & (C("dense_1") <= 1.0)
        & (C("dense_2") >= -1.0) & (C("dense_3") < 0.5),
        "ads_wide": (C("dense_0") > -0.5) & (C("dense_1") <= 1.0),
        "or": (C("dense_0") > 1.0) | (C("dense_1") < -1.0),
        "in": mod.In("user_id", [3, 17, 64, 65, 200]),
        "ne": (C("label") != 0) & (C("dense_0") > -0.5),
    }[kind]


def _pair(path, kind, use_kernel, build=lambda ds: ds):
    port = build(dataset(path, device="cpu")
                 .where(_pred(scan, kind))._with_kernel(use_kernel))
    ref = build(ref_dataset.dataset(path)
                .where(_pred(ref_scan, kind))._with_kernel(use_kernel))
    return port, ref


def _same_tables(a, b):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8))
        else:
            assert len(a[k]) == len(b[k])
            assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k]))


def _check(port, ref, **kw):
    rows = port.row_ids(**kw)
    assert np.array_equal(rows, ref.row_ids(**kw))
    table = port.to_table(**kw)
    _same_tables(table, ref.to_table(**kw))
    return rows, table


@pytest.mark.parametrize("use_kernel", KERNEL_ROUTES)
@pytest.mark.parametrize("file,kind,cols", [
    ("lm", "quality", ["doc_id", "quality", "tokens"]),
    ("ads", "ads_ranges", ["ts", "dense_0", "dense_3", "label"]),
])
def test_kernel_route_predicates(files, use_kernel, file, kind, cols):
    """Conjunctive ranges over f32 columns (BF16-dequantized on the ads
    table): the kernel route unless use_kernel=False."""
    tbl = ref_dataset.dataset(files[file]).select(cols).to_table()
    assert not any(np.any((v != 0) & (np.abs(v) < 1.2e-38))
                   for v in tbl.values() if getattr(v, "dtype", None) == np.float32)
    port, ref = _pair(files[file], kind, use_kernel, lambda d: d.select(cols))
    rows, _ = _check(port, ref)
    assert 0 < len(rows) < port.num_rows
    _check(port, ref, parallelism=2, io_depth=2)
    assert port.count_rows() == len(rows)


@pytest.mark.parametrize("use_kernel", KERNEL_ROUTES)
@pytest.mark.parametrize("kind", ["or", "in", "ne"])
def test_numpy_route_predicates(files, use_kernel, kind):
    """``Or``/``In``/``!=`` do not compile to ranges: NumPy ``evaluate``, or
    a ValueError in both packages when the kernel is asked for."""
    cols = ["user_id", "dense_0", "dense_1", "label"]
    port, ref = _pair(files["ads"], kind, use_kernel, lambda d: d.select(cols))
    if use_kernel:
        for ds in (port, ref):
            with pytest.raises(ValueError, match="conjunctive range"):
                ds.to_table()
        return
    rows, _ = _check(port, ref)
    assert len(rows) > 0


@pytest.mark.parametrize("use_kernel", KERNEL_ROUTES)
@pytest.mark.parametrize("shape", ["head", "with_rows", "raw"])
def test_plan_shapes(files, use_kernel, shape):
    cols = ["ts", "dense_0", "dense_2"]
    build = {
        "head": lambda d: d.select(cols).head(700),
        "with_rows": lambda d: d.select(cols).with_rows(
            np.arange(0, 4096, 5)),
        "raw": lambda d: d.select(cols).dequantized(False),
    }[shape]
    port, ref = _pair(files["ads"], "ads_ranges", use_kernel, build)
    rows, table = _check(port, ref)
    assert len(rows) > 0
    if shape == "head":
        assert len(rows) == 700
    if shape == "with_rows":
        assert np.all(rows % 5 == 0)
    if shape == "raw":
        assert table["dense_0"].dtype == np.uint16      # BF16 bits


@pytest.mark.parametrize("use_kernel", KERNEL_ROUTES)
@pytest.mark.parametrize("drop_deleted", [True, False])
def test_rows_deleted_by_the_reference(files, use_kernel, drop_deleted):
    """Erased rows read 0 in the raw row space (``drop_deleted(False)``)."""
    cols = ["ts", "dense_0", "dense_1"]
    build = lambda d: d.select(cols).drop_deleted(drop_deleted)  # noqa: E731
    port, ref = _pair(files["deleted"], "ads_wide", use_kernel, build)
    _check(port, ref)
    # `> 0` puts a subnormal bound on the erased zeros, where the reference's
    # kernel route flushes: the port equals the reference's NumPy route
    port, _ = _pair(files["deleted"], "ads_ranges", use_kernel, build)
    _, ref = _pair(files["deleted"], "ads_ranges", False, build)
    _check(port, ref)
    plain = dataset(files["deleted"], device="cpu").select(["ts"]) \
        .drop_deleted(drop_deleted).to_table()
    _same_tables(plain, ref_dataset.dataset(files["deleted"]).select(["ts"])
                 .drop_deleted(drop_deleted).to_table())
    assert len(plain["ts"]) == (4096 - 300 if drop_deleted else 4096)


def test_batches_and_scanner(files):
    port, ref = _pair(files["ads"], "ads_ranges", None,
                      lambda d: d.select(["ts", "dense_0"]))
    for a, b in zip(port.to_batches(batch_size=333),
                    ref.to_batches(batch_size=333), strict=True):
        _same_tables(a, b)
    from repro_torch.core import BullionReader
    with BullionReader(files["ads"]) as r:
        got = r.scanner.find_rows(_pred(scan, "ads_ranges"), device="cpu")
    assert np.array_equal(got, ref.row_ids())


def test_unported_terminals_raise(files):
    ds = dataset(files["ads"], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ds.write_to("unused")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ds.delete_where(scan.C("ts") < 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ds.profile()


def test_device_reaches_the_filter(files, monkeypatch):
    """The plan carries the device to ``eval_mask`` for every group."""
    seen = []
    real = port_dataset.executor.eval_mask

    def spy(pred, tbl, use_kernel, device=None):
        seen.append(device)
        return real(pred, tbl, use_kernel, device)

    monkeypatch.setattr(port_dataset.executor, "eval_mask", spy)
    ds = dataset(files["ads"], device="cpu").where(_pred(scan, "ads_ranges"))
    ds.to_table(parallelism=2)
    assert seen and all(str(d) == "cpu" for d in seen)
    assert len(seen) == len(ds.physical_plan().tasks)
