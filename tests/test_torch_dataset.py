"""The port's predicate read path, ``dataset(p, device="cpu")``, held against
the JAX package's ``repro.dataset.dataset(p)`` on the same files.

Tolerance: none. Row ids and every column are compared exactly, for each
route (``use_kernel`` None, True, False: the dequant and filter kernels'
plain versions, or NumPy). The data hold no subnormal values, where the
reference's kernel route differs (see ``tests/test_torch_filter.py``).
"""

import importlib

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
    quant, quant_deleted = str(d / "quant.bln"), str(d / "quant_deleted.bln")
    for path in (quant, quant_deleted):
        synthetic.write_quant_table(path, n_rows=4096, rows_per_group=1024)
    ref_core.delete_rows(quant_deleted,
                         np.sort(rng.choice(4096, 300, replace=False)))
    return {"lm": lm, "ads": ads, "deleted": deleted, "quant": quant,
            "quant_deleted": quant_deleted}


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
        "quant": (C("q_i8") > -0.5) & (C("q_i16") <= 2.0),
        "quant_u8_bf16": (C("q_u8") >= 2.5) & (C("q_bf16") < 0.5),
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


QUANT_COLS = ["id", "q_i8", "q_u8", "q_i16", "q_bf16", "q_fp8", "q_fp16"]
RAW_DTYPES = {"id": np.int64, "q_i8": np.int8, "q_u8": np.uint8,
              "q_i16": np.int16, "q_bf16": np.uint16, "q_fp8": np.uint8,
              "q_fp16": np.float16}


@pytest.mark.parametrize("use_kernel", KERNEL_ROUTES)
@pytest.mark.parametrize("dequantized", [True, False])
@pytest.mark.parametrize("kind", ["quant", "quant_u8_bf16"])
def test_quantized_reads(files, use_kernel, dequantized, kind):
    """Every kind of quantized column (INT8/UINT8/INT16 affine, BF16, FP8,
    FP16), predicates on the affine and BF16 columns: the filter and the
    zone maps see the dequantized values, the payload is dequantized or
    raw as asked."""
    build = lambda d: d.select(QUANT_COLS).dequantized(dequantized)  # noqa: E731
    port, ref = _pair(files["quant"], kind, use_kernel, build)
    rows, table = _check(port, ref)
    assert 0 < len(rows) < port.num_rows
    _check(port, ref, parallelism=2, io_depth=2)
    for name, col in table.items():
        want = RAW_DTYPES[name] if not dequantized or name == "id" \
            else np.float32
        assert col.dtype == want, name


@pytest.mark.parametrize("use_kernel", KERNEL_ROUTES)
@pytest.mark.parametrize("drop_deleted", [True, False])
def test_quantized_rows_deleted_by_the_reference(files, use_kernel,
                                                 drop_deleted):
    """Erased rows are stored 0 padded before the dequantize, so in the
    raw row space (``drop_deleted(False)``) they read as ``zero``."""
    build = lambda d: d.select(QUANT_COLS).drop_deleted(drop_deleted)  # noqa: E731
    port, ref = _pair(files["quant_deleted"], "quant", use_kernel, build)
    _check(port, ref)
    plain = dataset(files["quant_deleted"], device="cpu").select(QUANT_COLS) \
        .drop_deleted(drop_deleted)._with_kernel(use_kernel).to_table()
    _same_tables(plain, ref_dataset.dataset(files["quant_deleted"])
                 .select(QUANT_COLS).drop_deleted(drop_deleted).to_table())
    assert len(plain["id"]) == (4096 - 300 if drop_deleted else 4096)


@pytest.mark.parametrize("use_kernel", KERNEL_ROUTES)
def test_dequantize_route_by_mode(files, monkeypatch, use_kernel):
    """Only BF16 and the affine modes reach the dequant kernel: one
    ``dequant_columns`` call for each ``decode_group`` call that has such a
    column (float64 scale and zero, on the plan's device); FP8 and FP16
    never do, and ``use_kernel=False`` sends none."""
    dq = importlib.import_module("repro_torch.kernels.dequant")
    real, seen = dq.dequant_columns, []

    def spy(codes, params, *, device=None):
        seen.append(([c.dtype for c in codes], [len(c) for c in codes],
                     [type(v) for p in params for v in p], str(device)))
        return real(codes, params, device=device)

    monkeypatch.setattr(dq, "dequant_columns", spy)
    ds = dataset(files["quant"], device="cpu").select(QUANT_COLS) \
        .where(_pred(scan, "quant"))._with_kernel(use_kernel)
    ds.to_table()
    if use_kernel is False:
        assert seen == []
        return
    groups = len(ds.physical_plan().tasks)
    # per group: q_i16 and q_i8 for the predicate (sorted), then q_u8 and
    # q_bf16 in the order selected
    want = [[np.int16, np.int8], [np.uint8, np.uint16]] * groups
    assert [dtypes for dtypes, *_ in seen] == want
    assert all(lengths == [1024, 1024] and set(kinds) == {float}
               and dev == "cpu" for _, lengths, kinds, dev in seen)


@pytest.mark.parametrize("use_kernel", KERNEL_ROUTES)
def test_dequantize_spans_name_their_columns(files, use_kernel):
    """One ``decode.dequantize`` span for the kernel call with its column
    list, one for each NumPy column."""
    from repro_torch.obs import trace
    ds = dataset(files["quant"], device="cpu").select(QUANT_COLS) \
        .where(_pred(scan, "quant"))._with_kernel(use_kernel)
    with trace.collect() as tracer:
        ds.to_table()
    spans = [(r.args["route"], tuple(r.args["columns"]))
             for r in tracer.spans if r.name == "decode.dequantize"]
    groups = len(ds.physical_plan().tasks)
    numpy_cols = ["q_fp8", "q_fp16"]
    if use_kernel is False:
        numpy_cols = ["q_i8", "q_i16", "q_u8", "q_bf16", "q_fp8", "q_fp16"]
    else:
        kernel = [("kernel", ("q_i16", "q_i8")), ("kernel", ("q_u8", "q_bf16"))]
        assert [s for s in spans if s[0] == "kernel"] == kernel * groups
    assert sorted(c for route, cols in spans if route == "numpy"
                  for c in cols) == sorted(numpy_cols * groups)
    assert all(len(cols) == 1 for route, cols in spans if route == "numpy")
