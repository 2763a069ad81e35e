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
from repro_torch.kernels.dequant import dequant, dequant_ref, ops, to_bf16
from repro_torch.kernels.dequant.kernel import dequant_fwd

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
