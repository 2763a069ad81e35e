"""The port's storage engine on the CPU, held against the JAX package's:
byte-identical files from the two writers, quantization with the same bits,
and files of either package read back equal in the other.

Tolerance: none. Bytes, bits, row ids and values are compared exactly
(NaN bit patterns included). No field of a file is filled from the clock.
"""

import numpy as np
import pytest

import repro.core as ref_core
import repro.data.synthetic as ref_synthetic
import repro.dataset as ref_dataset
import repro_torch.core as core
import repro_torch.data as synthetic
from repro_torch.core.encodings.numeric import Chunked
from repro_torch.dataset import dataset

# float16 casts of ±inf, NaN and values past 65504 warn in both packages
pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

SPECIALS = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45,
                     -1e-40, 448.0, 463.99, 464.0, 464.0001, 465.7, 480.0,
                     -464.0, -464.0001, 1e30, -1e30, 3.4028235e38],
                    np.float32)


def _table_all_modes(n=3000, seed=0):
    """One float32 column per QuantMode (NaN, ±inf and fp8 overflow
    included), an int column and a string column, with schemas for both
    packages."""
    rng = np.random.default_rng(seed)
    cols, specs, ref_specs = {}, [], []
    for mode in core.QuantMode:
        x = (rng.normal(size=n) * 200).astype(np.float32)
        x[rng.choice(n, len(SPECIALS), replace=False)] = SPECIALS
        if "AFFINE" in mode.name:
            x = np.nan_to_num(x, posinf=900.0, neginf=-900.0)
            spec = core.affine_spec_for(x, mode)
        else:
            spec = core.QuantSpec(mode)
        name = f"q_{mode.name.lower()}"
        cols[name] = x
        specs.append(core.ColumnSpec(name, "float32", quant=spec))
        ref_specs.append(ref_core.ColumnSpec(name, "float32", quant=ref_core.QuantSpec(
            ref_core.QuantMode(int(mode)), spec.scale, spec.zero)))
    cols["id"] = np.arange(n, dtype=np.int64) * 7
    cols["name"] = [f"row-{i % 97}-{'x' * (i % 13)}".encode() for i in range(n)]
    specs += [core.ColumnSpec("id", "int64"), core.ColumnSpec("name", "string")]
    ref_specs += [ref_core.ColumnSpec("id", "int64"),
                  ref_core.ColumnSpec("name", "string")]
    return cols, specs, ref_specs


def _write(pkg, path, table, specs, **kw):
    w = pkg.BullionWriter(str(path), specs, **kw)
    w.write_table(table)
    return w.close()


def _same(a, b):
    """Equal values, NaN bit patterns included."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        assert a.shape == b.shape
        assert np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                              np.ascontiguousarray(b).view(np.uint8))
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))


def _same_tables(a, b):
    assert list(a) == list(b)
    for k in a:
        _same(a[k], b[k])


# -- the writers: byte-identical files ----------------------------------------


@pytest.mark.parametrize("which", ["lm_corpus", "ads_table"])
def test_synthetic_tables_byte_identical(tmp_path, which):
    port, ref = tmp_path / "port.bln", tmp_path / "ref.bln"
    if which == "lm_corpus":
        kw = dict(n_docs=96, doc_len=128, rows_per_group=32)
        synthetic.write_lm_corpus(str(port), **kw)
        ref_synthetic.write_lm_corpus(str(ref), **kw)
    else:
        kw = dict(n_rows=1024, n_sparse=2, n_dense=4, seq_len=16,
                  rows_per_group=512)
        synthetic.write_ads_table(str(port), **kw)
        ref_synthetic.write_ads_table(str(ref), **kw)
    assert port.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("page_rows", [None, 256])
def test_every_quant_mode_byte_identical(tmp_path, page_rows):
    table, specs, ref_specs = _table_all_modes()
    _write(core, tmp_path / "port.bln", table, specs, rows_per_group=1024,
           page_rows=page_rows)
    _write(ref_core, tmp_path / "ref.bln", table, ref_specs,
           rows_per_group=1024, page_rows=page_rows)
    assert (tmp_path / "port.bln").read_bytes() == \
        (tmp_path / "ref.bln").read_bytes()


# -- quantization: the same bits ----------------------------------------------


def _quant_inputs():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    return [SPECIALS, bits.view(np.float32),
            (rng.normal(size=50_000) * 300).astype(np.float32),
            rng.normal(size=50_000) * 300,                     # float64
            (rng.normal(size=5_000) * 1000).astype(np.float16)]


@pytest.mark.parametrize("mode", list(core.QuantMode),
                         ids=lambda m: m.name)
def test_quantize_dequantize_same_bits(mode):
    for x in _quant_inputs():
        if "AFFINE" in mode.name:
            x = np.nan_to_num(x.astype(np.float32), nan=0.0, posinf=1e3,
                              neginf=-1e3)
            spec = core.affine_spec_for(x, mode)
        else:
            spec = core.QuantSpec(mode)
        ref_spec = ref_core.QuantSpec(ref_core.QuantMode(int(mode)),
                                      spec.scale, spec.zero)
        with np.errstate(all="ignore"):
            q, rq = core.quantize(x, spec), ref_core.quantize(x, ref_spec)
            _same(q, rq)
            for out in (np.float32, np.float64):
                _same(core.dequantize(q, spec, out),
                      ref_core.dequantize(rq, ref_spec, out))


def test_fp8_overflow_and_nan_codes():
    x = np.array([448, 463.99, 464, 464.0001, 465.7, np.inf, -np.inf, np.nan,
                  -464, -464.0001], np.float32)
    q = core.quantize(x, core.QuantSpec(core.QuantMode.FP8_E4M3))
    assert q.tolist() == [0x7E, 0x7E, 0x7E, 0x7F, 0x7F, 0x7F, 0xFF, 0x7F,
                          0xFE, 0xFF]
    bf = core.quantize(np.array([np.nan, -np.nan], np.float32),
                       core.QuantSpec(core.QuantMode.BF16))
    assert bf.tolist() == [0x7FC0, 0xFFC0]


def test_every_bit_pattern_decodes_the_same():
    for mode, bits in ((core.QuantMode.BF16, np.arange(2**16, dtype=np.uint16)),
                       (core.QuantMode.FP8_E4M3, np.arange(256, dtype=np.uint8))):
        spec = core.QuantSpec(mode)
        ref_spec = ref_core.QuantSpec(ref_core.QuantMode(int(mode)))
        with np.errstate(all="ignore"):
            for out in (np.float32, np.float64):
                _same(core.dequantize(bits, spec, out),
                      ref_core.dequantize(bits, ref_spec, out))


# -- reading across packages --------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("dequant", [True, False])
def test_files_read_back_equal_in_either_package(tmp_path, writer, dequant):
    table, specs, ref_specs = _table_all_modes(n=2000, seed=1)
    path = tmp_path / "t.bln"
    if writer == "port":
        _write(core, path, table, specs, rows_per_group=512)
    else:
        _write(ref_core, path, table, ref_specs, rows_per_group=512)
    got = dataset(str(path), device="cpu").dequantized(dequant).to_table()
    want = ref_dataset.dataset(str(path)).dequantized(dequant).to_table()
    _same_tables(got, want)
    _same(got["id"], table["id"])
    _same(got["name"], table["name"])
    _same(got["q_none"], table["q_none"])


def test_synthetic_tables_read_back_equal(tmp_path):
    path = tmp_path / "ads.bln"
    synthetic.write_ads_table(str(path), n_rows=1024, n_sparse=2, n_dense=4,
                              seq_len=16, rows_per_group=256)
    _same_tables(dataset(str(path), device="cpu").to_table(),
                 ref_dataset.dataset(str(path)).to_table())


def test_chunked_needs_zstandard(monkeypatch):
    """Without zstandard the cascade never offers ``chunked``, and a chunked
    blob says what is missing."""
    import repro_torch.core.encodings.numeric as numeric
    from repro_torch.core.encodings.base import unframe
    arr = np.arange(5000, dtype=np.int64)
    enc, ctx = Chunked(), core.EncodeContext()
    blob = enc.encode(arr, ctx) if numeric.zstd is not None else None
    monkeypatch.setattr(numeric, "zstd", None)
    assert not enc.applicable(arr, ctx)
    if blob is not None:
        _, header, payload, _ = unframe(blob)
        with pytest.raises(RuntimeError, match="zstandard"):
            enc.decode(header, payload)


# -- bfloat16 columns (dtype code 12), without ml_dtypes ------------------------


def bf16_case(seed=0, n=4096):
    """The bf16 case of a column ``x`` (4096 values from a normal, with
    +-0, NaN, +-inf and a subnormal among them) as ``ml_dtypes.bfloat16``
    for the reference and its uint16 bit patterns for the port, and
    ``id``."""
    import ml_dtypes
    x = np.random.default_rng(seed).normal(size=n).astype(ml_dtypes.bfloat16)
    x[[5, 9, 2000]] = 0.0
    x[[11, 3000]] = -0.0
    x[[12, 13, 14]] = [np.nan, np.inf, -np.inf]
    x[15] = 1e-40
    return x, x.view(np.uint16), np.arange(n, dtype=np.int64)


def write_bf16_pair(tmp_path, seed=0):
    """The case written by each package's writer with
    ``ColumnSpec("x", "bfloat16")``, 1024 rows a group: (port path, ref
    path, the reference's values)."""
    x, bits, ids = bf16_case(seed)
    paths = []
    for pkg, table, name in ((core, {"x": bits, "id": ids}, "port.bln"),
                             (ref_core, {"x": x, "id": ids}, "ref.bln")):
        path = str(tmp_path / name)
        _write(pkg, path, table, [pkg.ColumnSpec("x", "bfloat16"),
                                  pkg.ColumnSpec("id", "int64")],
               rows_per_group=1024)
        paths.append(path)
    return paths[0], paths[1], x


def test_bf16_dtype_code_is_its_uint16_payload():
    from repro_torch.core.encodings.base import (_DTYPE_CODES, BF16_STORAGE,
                                                 code_dtype, code_name,
                                                 dtype_code)
    assert _DTYPE_CODES["bfloat16"] == 12
    assert code_dtype(12) == np.uint16 and code_name(12) == "bfloat16"
    assert dtype_code(BF16_STORAGE) == 12 and dtype_code(np.uint16) == 5


def test_bf16_writer_files_byte_identical(tmp_path):
    """The port's writer, given the bits, writes the reference's file:
    trivial pages of code 12, empty zone maps, the sketch keys of the
    values."""
    port, ref, _ = write_bf16_pair(tmp_path)
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_bf16_read_is_the_bits(tmp_path, writer):
    """A read hands back the uint16 bit patterns, equal bit for bit to the
    reference's bf16 values (NaN payloads included); rows and row ids as
    the reference's."""
    port, ref, x = write_bf16_pair(tmp_path)
    path = port if writer == "port" else ref
    with dataset(path, device="cpu") as ds:
        got = ds.to_table()
        rows = ds.select(["x"]).with_rows([0, 7, 1023, 1024, 4095]).to_table()
    with ref_dataset.dataset(ref) as rds:
        want = rds.select(["x"]).with_rows([0, 7, 1023, 1024, 4095]).to_table()
    assert got["x"].dtype == np.uint16
    _same(got["x"], x.view(np.uint16))
    _same(got["id"], np.arange(4096, dtype=np.int64))
    _same(rows["x"], want["x"].view(np.uint16))


@pytest.mark.parametrize("pred", ["gt0", "range", "eq0", "ne", "in"])
def test_bf16_predicates_match_reference(tmp_path, pred):
    """Predicates read the bits widened to f32 (exact): counts and the
    rows selected equal the reference's over its bf16 values, -0 == 0 and
    NaN matching nothing included."""
    from repro_torch.scan import C
    from repro.scan import C as RC
    port, ref, _ = write_bf16_pair(tmp_path)
    make = {"gt0": lambda c: c("x") > 0,
            "range": lambda c: (c("x") >= -0.5) & (c("x") < 1.25),
            "eq0": lambda c: c("x") == 0.0,
            "ne": lambda c: (c("x") != 0.0) & (c("id") < 100),
            "in": lambda c: c("x").isin([0.0, 1.0, float("inf")])}[pred]
    with dataset(port, device="cpu") as ds:
        n = ds.where(make(C)).count_rows()
        got = ds.where(make(C)).to_table()
    with ref_dataset.dataset(ref) as rds:
        want_n = rds.where(make(RC)).count_rows()
        want = rds.where(make(RC)).to_table()
    assert n == want_n > 0
    _same(got["id"], want["id"])
    _same(got["x"], want["x"].view(np.uint16))


def test_bf16_write_to_matches_reference(tmp_path):
    """``write_to`` of the bf16 file, whole and filtered: shards
    byte-identical to the reference's, the schema keeping code 12."""
    import os
    from repro_torch.scan import C
    from repro.scan import C as RC
    port, ref, _ = write_bf16_pair(tmp_path)
    for name, where in (("all", None), ("pos", "gt0")):
        out, ref_out = str(tmp_path / f"{name}-port"), str(tmp_path / f"{name}-ref")
        with dataset(port, device="cpu") as ds:
            res = (ds.where(C("x") > 0) if where else ds).write_to(out)
        with ref_dataset.dataset(ref) as rds:
            ref_res = (rds.where(RC("x") > 0) if where else rds).write_to(
                ref_out)
        assert res.rows == ref_res.rows
        assert sorted(os.listdir(out)) == sorted(os.listdir(ref_out))
        for f in os.listdir(out):
            with open(os.path.join(out, f), "rb") as a, \
                    open(os.path.join(ref_out, f), "rb") as b:
                assert a.read() == b.read(), (name, f)
    assert res.rows < 4096


def test_bf16_writer_takes_only_bits(tmp_path):
    spec = [core.ColumnSpec("x", "bfloat16")]
    with pytest.raises(TypeError, match="uint16 bit patterns"):
        _write(core, tmp_path / "f.bln", {"x": np.zeros(4, np.float32)}, spec)
