"""Storage quantization (Bullion §2.4).

Model-quantization techniques applied *in storage*: per-feature (per-column)
mixed precision, dynamically tunable.  Float features/embeddings store as
BF16/FP16/FP8 or affine INT8; integer features re-range losslessly (the
catalog's Dictionary/FOR encodings already provide the paper's "rehash to a
smaller range").  Includes the paper's dual-FP16 decomposition of FP32 across
two columns with a 1:1 rejoin.

Storage dtypes are carried as plain numpy views (bf16 -> uint16, fp8 ->
uint8) so every catalog encoding composes with quantized columns; the logical
dtype + params live in the footer's QUANT_META section.

The bf16 and fp8 conversions are bit arithmetic in NumPy, giving the bits
that ``ml_dtypes`` gives: round to nearest even from float32 (wider inputs
are first rounded to float32, as ``ml_dtypes`` does), NaN kept with its sign
as the canonical quiet NaN, and fp8 values that round past 448 (and ±inf)
stored as NaN, since e4m3fn has no infinity.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from enum import IntEnum

import numpy as np


class QuantMode(IntEnum):
    NONE = 0
    BF16 = 1
    FP16 = 2
    FP8_E4M3 = 3
    INT8_AFFINE = 4
    UINT8_AFFINE = 5
    INT16_AFFINE = 6
    DUAL_FP16_HI = 7   # paper's FP32 -> two FP16 columns
    DUAL_FP16_LO = 8


# footer QUANT_META entry: mode u8, pad[7], scale f64, zero f64  (24 B/col)
QUANT_DTYPE = np.dtype([("mode", "<u1"), ("_pad", "<u1", 7),
                        ("scale", "<f8"), ("zero", "<f8")])


@dataclass(frozen=True)
class QuantSpec:
    mode: QuantMode = QuantMode.NONE
    scale: float = 1.0
    zero: float = 0.0

    def to_record(self) -> np.ndarray:
        rec = np.zeros(1, QUANT_DTYPE)
        rec["mode"] = int(self.mode)
        rec["scale"] = self.scale
        rec["zero"] = self.zero
        return rec

    @staticmethod
    def from_record(rec: np.ndarray) -> "QuantSpec":
        return QuantSpec(QuantMode(int(rec["mode"])), float(rec["scale"]),
                         float(rec["zero"]))


def _bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float -> bfloat16 bit patterns (uint16), round to nearest even."""
    x = np.asarray(arr).astype(np.float32)
    u = x.view(np.uint32)
    rounded = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))
               >> 16).astype(np.uint16)
    nan = ((u >> 16) & np.uint32(0x8000)).astype(np.uint16) | np.uint16(0x7FC0)
    return np.where(np.isnan(x), nan, rounded)


def _bf16_values(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32, exact."""
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32)


def _fp8_e4m3fn_bits(arr: np.ndarray) -> np.ndarray:
    """float -> float8_e4m3fn bit patterns (uint8), round to nearest even.

    With the exponent clamped at e4m3fn's least (-6), a finite |x| rounds to
    q quanta of 2**(e - 3), q in [0, 16], and its code is (e + 6) * 8 + q
    for subnormals and normals alike; codes past 0x7e (448) are NaN."""
    x = np.asarray(arr).astype(np.float32)
    sign = ((x.view(np.uint32) >> 24) & np.uint32(0x80)).astype(np.uint8)
    a = np.abs(x).astype(np.float64)
    finite = np.isfinite(a)
    a = np.where(finite, a, 0.0)
    _, ex = np.frexp(a)
    e = np.where(a == 0, -6, np.maximum(ex - 1, -6))
    q = np.rint(np.ldexp(a, 3 - e))
    code = (e + 6) * 8 + q.astype(np.int64)
    code = np.where(finite & (code <= 0x7E), code, 0x7F).astype(np.uint8)
    return code | sign


def _fp8_e4m3fn_table() -> np.ndarray:
    b = np.arange(256)
    e, m = (b >> 3) & 15, b & 7
    mag = np.where(e == 0, np.ldexp(m, -9), np.ldexp(8 + m, e - 10))
    vals = np.where(b >> 7, -mag, mag).astype(np.float32)
    bits = vals.view(np.uint32)
    bits[0x7F], bits[0xFF] = 0x7FC00000, 0xFFC00000      # the two NaNs
    return bits.view(np.float32)


_FP8_E4M3FN = _fp8_e4m3fn_table()


def storage_dtype(mode: QuantMode) -> np.dtype:
    return {
        QuantMode.NONE: None,
        QuantMode.BF16: np.dtype(np.uint16),
        QuantMode.FP16: np.dtype(np.float16),
        QuantMode.FP8_E4M3: np.dtype(np.uint8),
        QuantMode.INT8_AFFINE: np.dtype(np.int8),
        QuantMode.UINT8_AFFINE: np.dtype(np.uint8),
        QuantMode.INT16_AFFINE: np.dtype(np.int16),
        QuantMode.DUAL_FP16_HI: np.dtype(np.float16),
        QuantMode.DUAL_FP16_LO: np.dtype(np.float16),
    }[mode]


def quantize(arr: np.ndarray, spec: QuantSpec) -> np.ndarray:
    m = spec.mode
    if m == QuantMode.NONE:
        return arr
    if m == QuantMode.BF16:
        return _bf16_bits(arr)
    if m == QuantMode.FP16:
        return arr.astype(np.float16)
    if m == QuantMode.FP8_E4M3:
        return _fp8_e4m3fn_bits(arr)
    if m in (QuantMode.INT8_AFFINE, QuantMode.UINT8_AFFINE, QuantMode.INT16_AFFINE):
        dt = storage_dtype(m)
        info = np.iinfo(dt)
        q = np.round((arr.astype(np.float64) - spec.zero) / spec.scale)
        return np.clip(q, info.min, info.max).astype(dt)
    if m == QuantMode.DUAL_FP16_HI:
        return arr.astype(np.float16)
    if m == QuantMode.DUAL_FP16_LO:
        hi = arr.astype(np.float16).astype(np.float32)
        return (arr.astype(np.float32) - hi).astype(np.float16)
    raise ValueError(m)


def dequantize(arr: np.ndarray, spec: QuantSpec,
               out_dtype=np.float32) -> np.ndarray:
    m = spec.mode
    if m == QuantMode.NONE:
        return arr
    if m == QuantMode.BF16:
        return _bf16_values(arr.view(np.uint16)).astype(out_dtype)
    if m in (QuantMode.FP16, QuantMode.DUAL_FP16_HI, QuantMode.DUAL_FP16_LO):
        return arr.astype(out_dtype)
    if m == QuantMode.FP8_E4M3:
        return _FP8_E4M3FN[arr.view(np.uint8)].astype(out_dtype)
    if m in (QuantMode.INT8_AFFINE, QuantMode.UINT8_AFFINE, QuantMode.INT16_AFFINE):
        return (arr.astype(np.float64) * spec.scale + spec.zero).astype(out_dtype)
    raise ValueError(m)


def rejoin_dual_fp16(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """The paper's 1:1 join of the two FP16 halves back to ~FP32."""
    return hi.astype(np.float32) + lo.astype(np.float32)


def affine_spec_for(arr: np.ndarray, mode: QuantMode) -> QuantSpec:
    """Fit scale/zero to the column's observed range."""
    dt = storage_dtype(mode)
    info = np.iinfo(dt)
    lo, hi = float(arr.min()), float(arr.max())
    if hi == lo:
        return QuantSpec(mode, 1.0, lo)
    scale = (hi - lo) / (info.max - info.min)
    zero = lo - info.min * scale
    return QuantSpec(mode, scale, zero)


def suggest_spec(arr: np.ndarray, rel_tolerance: float = 1e-2) -> QuantSpec:
    """Mixed-precision policy: pick the cheapest storage meeting a relative
    error tolerance on this feature (the paper's per-feature sensitivity)."""
    if arr.dtype.kind != "f":
        return QuantSpec(QuantMode.NONE)
    scale = float(np.abs(arr).max()) or 1.0
    for mode in (QuantMode.FP8_E4M3, QuantMode.INT8_AFFINE, QuantMode.BF16,
                 QuantMode.FP16):
        spec = affine_spec_for(arr, mode) if "AFFINE" in mode.name else QuantSpec(mode)
        err = np.abs(dequantize(quantize(arr, spec), spec) - arr).max() / scale
        if err <= rel_tolerance:
            return spec
    return QuantSpec(QuantMode.NONE)
