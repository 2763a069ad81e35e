"""The port's dequant on the CPU (its plain version), held against the JAX
package's Pallas kernel (interpret mode), its jnp oracle, and the storage
layer's NumPy ``dequantize``.

Tolerances. float32 arithmetic, float32 output: ``np.allclose(...,
atol=1e-3)`` as ``tests/test_kernels.py`` (XLA may fuse the multiply and the
add, one ulp apart; the port never fuses them, and equals NumPy's separate
float32 multiply and add bit for bit). float32 arithmetic, bfloat16 output:
equal. bf16 bits: equal, NaN payloads and subnormal codes included. float64
arithmetic (the read path's route): equal to
``repro.core.quantization.dequantize`` on every code.

The column list (``dequant_columns``, the read path's entry) runs float64
arithmetic: equal to ``dequantize`` bit for bit, and within ``atol=1e-3`` of
the Pallas kernel's float32 arithmetic (equal for bf16 bits).
"""

import sys
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.quantization import QuantMode as RefQuantMode
from repro.core.quantization import QuantSpec as RefQuantSpec
from repro.core.quantization import affine_spec_for as ref_affine_spec_for
from repro.core.quantization import dequantize as ref_dequantize
from repro.kernels.dequant import dequant as jax_dequant
from repro.kernels.dequant import dequant_ref as jax_dequant_ref
from repro_torch.kernels.dequant import (dequant, dequant_columns,
                                        dequant_packed, dequant_packed_ref,
                                        dequant_ref, ops, pack_columns,
                                        to_bf16)
from repro_torch.kernels.dequant.kernel import dequant_fwd, dequant_packed_fwd
from repro_torch.kernels.dequant.staging import (CODE_TYPES, DESC_DTYPE,
                                                 TILE_BYTES, descriptors)

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
AFFINE = [np.int8, np.uint8, np.int16]


def _bits(x):
    """Bit patterns of a float32/bfloat16 tensor or array, as NumPy."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)
        x = x.numpy()
    x = np.asarray(x)
    return x.view(np.uint32 if x.itemsize == 4 else np.uint16)


def _affine_inputs(code, shape=(130, 70), seed=1):
    """The draw of tests/test_kernels.py::test_dequant_affine."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(code)
    q = rng.integers(info.min, info.max, shape).astype(code)
    scale = rng.random(shape[1]).astype(np.float32) + 0.1
    zero = rng.normal(size=shape[1]).astype(np.float32)
    return q, scale, zero


def _port(q, scale, zero, out_dtype):
    return dequant(torch.from_numpy(q), torch.from_numpy(scale),
                   torch.from_numpy(zero), out_dtype, device="cpu")


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("code", AFFINE)
def test_affine_matches_pallas_kernel_and_oracle(code, out_dtype):
    q, scale, zero = _affine_inputs(code)
    got = _port(q, scale, zero, out_dtype)
    assert got.dtype == out_dtype and got.shape == q.shape
    kern = np.asarray(jax_dequant(q, scale, zero, out_dtype=JNP[out_dtype]))
    oracle = np.asarray(jax_dequant_ref(jnp.asarray(q), jnp.asarray(scale),
                                        jnp.asarray(zero), JNP[out_dtype]))
    if out_dtype == torch.float32:
        assert np.allclose(got.numpy(), kern, atol=1e-3)
        assert np.allclose(got.numpy(), oracle, atol=1e-3)
    else:
        assert np.array_equal(_bits(got), _bits(kern))
        assert np.array_equal(_bits(got), _bits(oracle))


@pytest.mark.parametrize("code", AFFINE)
def test_affine_f32_is_a_separate_multiply_and_add(code):
    """float32 arithmetic as NumPy computes it: rounded after the multiply
    and after the add, bit for bit."""
    q, scale, zero = _affine_inputs(code, seed=3)
    want = q.astype(np.float32) * scale + zero
    assert np.array_equal(_bits(_port(q, scale, zero, torch.float32)),
                          _bits(want))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_bf16_bits_match_pallas_kernel(out_dtype):
    """Every kind of bf16 pattern: a uniform draw of codes holds NaNs with
    payloads and subnormals; both survive the reinterpretation."""
    rng = np.random.default_rng(4)
    q = rng.integers(0, 2**16, (256, 128)).astype(np.uint16)
    exp, man = (q >> 7) & 0xFF, q & 0x7F
    assert ((exp == 0) & (man != 0)).sum() > 0        # subnormal codes
    assert ((exp == 0xFF) & (man != 0)).sum() > 0     # NaN codes
    ones, zeros = np.ones(128, np.float32), np.zeros(128, np.float32)
    got = _port(q, ones, zeros, out_dtype)
    kern = np.asarray(jax_dequant(q, ones, zeros, out_dtype=JNP[out_dtype]))
    oracle = np.asarray(jax_dequant_ref(jnp.asarray(q), jnp.asarray(ones),
                                        jnp.asarray(zeros), JNP[out_dtype]))
    assert np.array_equal(_bits(got), _bits(kern))
    assert np.array_equal(_bits(got), _bits(oracle))
    if out_dtype == torch.float32:      # the pattern, shifted up: exact
        assert np.array_equal(_bits(got), q.astype(np.uint32) << 16)


COLUMNS = {
    "normal": lambda rng: rng.normal(size=50_000),
    "uniform": lambda rng: rng.uniform(-3.0, 7.0, 50_000),
    "skewed": lambda rng: rng.lognormal(0.0, 1.5, 50_000),
    "constant": lambda rng: np.full(1000, 2.5),     # scale 1, zero lo
}
MODES = {np.int8: RefQuantMode.INT8_AFFINE, np.uint8: RefQuantMode.UINT8_AFFINE,
         np.int16: RefQuantMode.INT16_AFFINE}


@pytest.mark.parametrize("column", list(COLUMNS))
@pytest.mark.parametrize("code", AFFINE)
def test_f64_route_every_code_equals_dequantize(code, column):
    """The read path's route: float64 scale and zero, float32 out, equal to
    the storage layer's NumPy ``dequantize`` on every code."""
    spec = ref_affine_spec_for(COLUMNS[column](np.random.default_rng(5)),
                               MODES[code])
    if column == "constant":
        assert (spec.scale, spec.zero) == (1.0, 2.5)
    info = np.iinfo(code)
    codes = np.arange(info.min, info.max + 1).astype(code)
    params = np.array([spec.scale, spec.zero])
    got = _port(codes.reshape(-1, 1), params[:1], params[1:], torch.float32)
    assert np.array_equal(_bits(got).reshape(-1),
                          _bits(ref_dequantize(codes, spec)))


def test_f64_route_every_bf16_pattern_equals_dequantize():
    codes = np.arange(2**16, dtype=np.uint32).astype(np.uint16)
    params = np.zeros(2)
    got = _port(codes.reshape(-1, 1), params[:1], params[1:], torch.float32)
    want = ref_dequantize(codes, RefQuantSpec(RefQuantMode.BF16))
    assert np.array_equal(_bits(got).reshape(-1), _bits(want))


def test_f64_to_bf16_rounds_through_f32():
    """float64 arithmetic with bfloat16 output: rounded to float32 first,
    then to bfloat16, as PyTorch casts."""
    q, scale, zero = _affine_inputs(np.int16, seed=6)
    s64, z64 = scale.astype(np.float64), zero.astype(np.float64)
    f32 = (q.astype(np.float64) * s64 + z64).astype(np.float32)
    want = f32.astype(ml_dtypes.bfloat16)
    assert np.array_equal(_bits(_port(q, s64, z64, torch.bfloat16)),
                          _bits(want))


def test_transposed_strided_view():
    q, scale, zero = _affine_inputs(np.int8, shape=(260, 600), seed=7)
    view = torch.from_numpy(q).t()[::3, 4:]            # strides (3, 600)
    assert not view.is_contiguous()
    s, z = (torch.from_numpy(np.resize(a, view.shape[1])) for a in (scale, zero))
    got = dequant(view, s, z, torch.bfloat16, device="cpu")
    assert got.is_contiguous()
    want = jax_dequant(np.ascontiguousarray(view.numpy()), s.numpy(), z.numpy(),
                       out_dtype=jnp.bfloat16)
    assert np.array_equal(_bits(got), _bits(np.asarray(want)))


def test_to_bf16_matches_ml_dtypes():
    """Random float32 bit patterns (NaNs of both signs, subnormals, ±inf,
    values that round up to inf) convert as ml_dtypes converts them."""
    rng = np.random.default_rng(8)
    u = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    u[:6] = [0x7F800001, 0xFFC12345, 0x7F7FFFFF, 0x00000001, 0x80008000,
             0xFF800000]
    f = u.view(np.float32)
    got = to_bf16(torch.from_numpy(f))
    with np.errstate(invalid="ignore"):
        want = f.astype(ml_dtypes.bfloat16)
    assert np.array_equal(_bits(got), _bits(want))


def test_plain_version_is_the_wrapper_on_cpu():
    q, scale, zero = _affine_inputs(np.uint8, seed=9)
    t = [torch.from_numpy(a) for a in (q, scale, zero)]
    assert torch.equal(dequant(*t, torch.float32, device="cpu"),
                       dequant_ref(*t, torch.float32))


def test_checks_and_cpu_route_launches_nothing():
    q = torch.zeros((4, 3), dtype=torch.int8)
    s = torch.ones(3)
    before = dequant.launches
    assert dequant(q, s, s, device="cpu").shape == (4, 3)
    assert dequant(torch.zeros((0, 3), dtype=torch.int8), s, s,
                   device="cpu").shape == (0, 3)
    assert dequant.launches == before
    with pytest.raises(ValueError, match="dtypes"):
        dequant(q.to(torch.int32), s, s, device="cpu")
    with pytest.raises(ValueError, match="dtypes"):
        dequant(q, s, s.double(), device="cpu")
    with pytest.raises(ValueError, match="dtypes"):
        dequant(q, s, s, torch.float16, device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        dequant(q, torch.ones(4), torch.ones(4), device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        dequant_fwd(q, s, s, torch.empty((4, 3)))


def test_launch_count_loses_no_update_across_threads():
    """The read path dequantizes from a thread pool: the count is locked."""
    before = dequant.launches
    threads = [threading.Thread(target=lambda: [
        ops._count_launch() for _ in range(2000)]) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert dequant.launches == before + 16 * 2000
    dequant.launches = before


# ---------------------------------------------------------------------------
# the column list: one staging buffer, one launch
# ---------------------------------------------------------------------------

MODE_OF = {np.int8: RefQuantMode.INT8_AFFINE, np.uint8: RefQuantMode.UINT8_AFFINE,
           np.int16: RefQuantMode.INT16_AFFINE, np.uint16: RefQuantMode.BF16}


def _mixed_group(seed, n_cols, max_rows=5000):
    """Columns of all four code types at odd lengths (one empty), each with
    the spec the writer would give it."""
    rng = np.random.default_rng(seed)
    codes, specs = [], []
    for i in range(n_cols):
        code = list(MODE_OF)[i % 4]
        rows = 0 if i == 2 else int(rng.integers(1, max_rows)) | 1
        info = np.iinfo(code)
        codes.append(rng.integers(info.min, info.max + 1, rows).astype(code))
        if code == np.uint16:
            specs.append(RefQuantSpec(RefQuantMode.BF16))
        else:
            specs.append(ref_affine_spec_for(rng.normal(size=100) * (i + 1),
                                             MODE_OF[code]))
    return codes, specs


@pytest.mark.parametrize("n_cols", [1, 7, 70])
def test_columns_equal_dequantize_and_pallas_kernel(n_cols):
    """Column by column, bit for bit against NumPy ``dequantize``, and
    against the Pallas kernel (float32 arithmetic) within its tolerance."""
    codes, specs = _mixed_group(20 + n_cols, n_cols)
    got = dequant_columns(codes, [(sp.scale, sp.zero) for sp in specs],
                          device="cpu")
    assert len(got) == n_cols
    for q, spec, g in zip(codes, specs, got):
        assert g.dtype == torch.float32 and g.shape == q.shape
        assert np.array_equal(_bits(g), _bits(ref_dequantize(q, spec)))
        if not len(q):          # the Pallas wrapper takes no empty column
            continue
        one = np.ones(1, np.float32)
        scale, zero = one * np.float32(spec.scale), one * np.float32(spec.zero)
        kern = np.asarray(jax_dequant(q.reshape(-1, 1), scale, zero,
                                      out_dtype=jnp.float32)).reshape(-1)
        if q.dtype == np.uint16:
            assert np.array_equal(_bits(g), _bits(kern))
        else:
            assert np.allclose(g.numpy(), kern, atol=1e-3)


@pytest.mark.parametrize("n_cols", [0, 1, 5, 64])
def test_pack_columns_round_trips(n_cols):
    """The staging buffer: descriptors at the head, codes at 16-byte
    aligned offsets after it and read back unchanged, outputs at 16-byte
    aligned offsets that do not overlap, tiles of TILE_BYTES of codes."""
    codes, specs = _mixed_group(30 + n_cols, n_cols, max_rows=20_000)
    params = [(sp.scale, sp.zero) for sp in specs]
    packed = pack_columns(codes, params)
    buf = packed.buffer
    assert buf.dtype == torch.uint8 and buf.dim() == 1
    desc = descriptors(buf, n_cols)
    assert DESC_DTYPE.itemsize == 64 and len(desc) == n_cols
    end, out_end, tile = -(-n_cols * 64 // 16) * 16, 0, 0
    host = buf.numpy()
    for d, q, (scale, zero) in zip(desc, codes, params):
        off, at, rows = int(d["code_offset"]), int(d["out_offset"]), int(d["rows"])
        assert off % 16 == 0 and off >= end and at % 4 == 0 and at >= out_end
        assert rows == len(q) and int(d["q_type"]) == CODE_TYPES[q.dtype]
        assert (d["scale"], d["zero"]) == (scale, zero)
        assert int(d["tile_start"]) == tile
        assert np.array_equal(host[off:off + q.nbytes].view(q.dtype), q)
        end, out_end = off + q.nbytes, at + rows
        tile += -(-q.nbytes // TILE_BYTES)
    assert buf.numel() >= end and packed.n_out >= out_end
    assert packed.n_tiles == tile and packed.n_cols == n_cols
    assert packed.rows == tuple(len(q) for q in codes)
    assert packed.out_offsets == tuple(int(o) for o in desc["out_offset"])


def test_pack_columns_takes_tensors_and_strided_arrays():
    rng = np.random.default_rng(40)
    base = rng.integers(-2**15, 2**15, 3001).astype(np.int16)
    codes = [base[::3], torch.from_numpy(base[:100].copy())]
    packed = pack_columns(codes, [(0.5, 1.0), (2.0, -1.0)])
    host, desc = packed.buffer.numpy(), descriptors(packed.buffer, 2)
    for d, q in zip(desc, [base[::3], base[:100]]):
        off = int(d["code_offset"])
        assert np.array_equal(host[off:off + q.nbytes].view(np.int16), q)


def _hand_packed(codes, params, code_offsets, out_offsets):
    """A staging buffer laid out by hand, at offsets the packer would not
    choose (only aligned to the code's size)."""
    desc = np.zeros(len(codes), DESC_DTYPE)
    tile = 0
    for d, q, (scale, zero), off, at in zip(desc, codes, params, code_offsets,
                                            out_offsets):
        d["code_offset"], d["out_offset"], d["rows"] = off, at, len(q)
        d["tile_start"], d["scale"], d["zero"] = tile, scale, zero
        d["q_type"] = CODE_TYPES[q.dtype]
        tile += -(-q.nbytes // TILE_BYTES)
    host = np.zeros(max(o + q.nbytes for o, q in zip(code_offsets, codes)),
                    np.uint8)
    host[:desc.nbytes] = desc.view(np.uint8)
    for q, off in zip(codes, code_offsets):
        host[off:off + q.nbytes].view(q.dtype)[:] = q
    return torch.from_numpy(host), tile


def test_packed_plain_version_reads_unaligned_columns():
    """``dequant_packed_ref`` follows the descriptors, not the packer's
    alignment: codes at odd (size-aligned) offsets, outputs back to back."""
    rng = np.random.default_rng(41)
    codes = [rng.integers(-128, 128, 37).astype(np.int8),
             rng.integers(0, 2**16, 1001).astype(np.uint16),
             rng.integers(0, 256, 9000).astype(np.uint8),
             rng.integers(-2**15, 2**15, 17).astype(np.int16)]
    params = [(0.25, -3.0), (0.0, 0.0), (0.01, 5.0), (1e-3, 0.5)]
    code_offsets = [4 * 64 + 1, 4 * 64 + 40, 4 * 64 + 2043, 4 * 64 + 11_050]
    out_offsets = list(np.cumsum([0] + [len(q) for q in codes[:-1]]) + 3)
    staging, n_tiles = _hand_packed(codes, params, code_offsets, out_offsets)
    n_out = out_offsets[-1] + len(codes[-1])
    out = dequant_packed(staging, 4, n_tiles, n_out)
    assert np.array_equal(_bits(out),
                          _bits(dequant_packed_ref(staging, 4, n_out)))
    for q, (scale, zero), at in zip(codes, params, out_offsets):
        spec = RefQuantSpec(RefQuantMode.BF16) if q.dtype == np.uint16 \
            else RefQuantSpec(MODE_OF[q.dtype.type], scale, zero)
        assert np.array_equal(_bits(out[at:at + len(q)]),
                              _bits(ref_dequantize(q, spec)))


def test_columns_checks_and_cpu_route_launches_nothing():
    before = (dequant.launches, dequant_packed.launches)
    assert dequant_columns([], [], device="cpu") == []
    empty = dequant_columns([np.zeros(0, np.int8)], [(1.0, 0.0)], device="cpu")
    assert [tuple(e.shape) for e in empty] == [(0,)]
    assert (dequant.launches, dequant_packed.launches) == before
    with pytest.raises(ValueError, match="codes"):
        dequant_columns([np.zeros(4, np.int32)], [(1.0, 0.0)], device="cpu")
    with pytest.raises(ValueError, match="codes"):
        dequant_columns([np.zeros((2, 2), np.int8)], [(1.0, 0.0)],
                        device="cpu")
    with pytest.raises(ValueError, match="columns"):
        dequant_columns([np.zeros(4, np.int8)], [], device="cpu")
    packed = pack_columns([np.zeros(4, np.int8)], [(1.0, 0.0)])
    with pytest.raises(ValueError, match="CUDA device"):
        dequant_packed_fwd(packed.buffer, 1, 1, torch.empty(4))


def test_columns_do_not_alias_a_reused_buffer():
    """Each call hands back views of its own output: a later call leaves
    the earlier columns as they were."""
    codes, specs = _mixed_group(42, 6)
    params = [(sp.scale, sp.zero) for sp in specs]
    first = dequant_columns(codes, params, device="cpu")
    kept = [_bits(c).copy() for c in first]
    dequant_columns([c[::-1].copy() for c in codes], params, device="cpu")
    assert all(np.array_equal(_bits(a), b) for a, b in zip(first, kept))


@pytest.mark.parametrize("given", ["part_of_a_buffer", "wrong_dtype",
                                   "wrong_size"])
def test_packed_writes_into_a_given_output(given):
    """``dequant_packed`` writes into the ``out`` it is given (a part of a
    larger buffer, as the read path's decode hands it) the bits it returns
    without one, and refuses an output of another dtype or size."""
    codes, specs = _mixed_group(7, 4)
    packed = pack_columns(codes, [(sp.scale, sp.zero) for sp in specs])
    args = (packed.buffer, packed.n_cols, packed.n_tiles, packed.n_out)
    want = dequant_packed(*args)
    if given == "part_of_a_buffer":
        buf = torch.full((4 * packed.n_out + 256,), 0xAB, dtype=torch.uint8)
        out = buf[256:].view(torch.float32)
        assert dequant_packed(*args, out=out) is out
        assert np.array_equal(_bits(out), _bits(want))
        assert bool((buf[:256] == 0xAB).all())
        return
    out = torch.empty(packed.n_out, dtype=torch.float64) \
        if given == "wrong_dtype" else torch.empty(packed.n_out + 4)
    with pytest.raises(ValueError, match="need float32"):
        dequant_packed(*args, out=out)
