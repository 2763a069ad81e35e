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


def test_bf16_dtype_code_raises():
    from repro_torch.core.encodings.base import code_dtype, _DTYPE_CODES
    assert _DTYPE_CODES["bfloat16"] == 12
    with pytest.raises(TypeError, match="bfloat16"):
        code_dtype(12)
