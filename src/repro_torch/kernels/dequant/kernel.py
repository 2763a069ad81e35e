"""Binding of the Hopper dequant kernel (``csrc/dequant.cu``).

``dequant_fwd`` (the ``[R, C]`` body) and ``dequant_packed_fwd`` (the
column-list body) check the tensors, then launch the kernel on PyTorch's
current stream (the calling thread's). It does not synchronise; a refused
launch raises here, a fault during the run shows at the next
synchronisation.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .staging import DESC_DTYPE

Q_TYPES = {torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.uint16: 3}
ARITH_TYPES = (torch.float32, torch.float64)
OUT_TYPES = (torch.float32, torch.bfloat16)


def _fn():
    fn = _build.load("dequant").lib.dequant_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_longlong] * 4
                       + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def dequant_fwd(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                out: torch.Tensor) -> None:
    """q: [R, C] int8/uint8/int16/uint16 at any strides; scale, zero: [C]
    float32 or float64, contiguous; out: [R, C] float32 or bfloat16,
    contiguous; all on one CUDA device."""
    if q.dim() != 2:
        raise ValueError(f"q must be [R, C], got shape {tuple(q.shape)}")
    R, C = q.shape
    if not all(t.is_cuda and t.device == q.device for t in (q, scale, zero, out)):
        raise ValueError("q, scale, zero and out must be on one CUDA device")
    if q.dtype not in Q_TYPES or scale.dtype not in ARITH_TYPES \
            or zero.dtype != scale.dtype or out.dtype not in OUT_TYPES:
        raise ValueError(f"dtypes q {q.dtype}, scale {scale.dtype}, zero "
                         f"{zero.dtype}, out {out.dtype}")
    if scale.shape != (C,) or zero.shape != (C,) or out.shape != (R, C):
        raise ValueError(f"shapes scale {tuple(scale.shape)} zero "
                         f"{tuple(zero.shape)} out {tuple(out.shape)} for q "
                         f"{tuple(q.shape)}")
    if not (scale.is_contiguous() and zero.is_contiguous()
            and out.is_contiguous()):
        raise ValueError("scale, zero and out must be contiguous")
    stride_r, stride_c = q.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), Q_TYPES[q.dtype], R, C, stride_r, stride_c,
                    scale.data_ptr(), zero.data_ptr(),
                    int(scale.dtype == torch.float64), out.data_ptr(),
                    int(out.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"dequant launch failed: CUDA error {err}")


def _packed_fn():
    fn = _build.load("dequant").lib.dequant_columns_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def dequant_packed_fwd(staging: torch.Tensor, n_cols: int, n_tiles: int,
                       out: torch.Tensor) -> None:
    """staging: uint8[nbytes] of ``staging.pack_columns`` (descriptors, then
    codes), 16-byte aligned; out: float32[n_out] contiguous, large enough
    for every column; both on one CUDA device."""
    if not (staging.is_cuda and out.is_cuda and staging.device == out.device):
        raise ValueError("staging and out must be on one CUDA device")
    if staging.dtype != torch.uint8 or staging.dim() != 1 \
            or not staging.is_contiguous() or staging.data_ptr() % 16:
        raise ValueError("staging must be a contiguous, 16-byte-aligned "
                         "uint8 vector")
    if out.dtype != torch.float32 or out.dim() != 1 \
            or not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError("out must be a contiguous, 16-byte-aligned float32 "
                         "vector")
    if staging.numel() < n_cols * DESC_DTYPE.itemsize:
        raise ValueError(f"staging of {staging.numel()} bytes holds no "
                         f"{n_cols} descriptors")
    with torch.cuda.device(staging.device):
        stream = torch.cuda.current_stream(staging.device).cuda_stream
        err = _packed_fn()(staging.data_ptr(), n_cols, n_tiles,
                           out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dequant_columns launch failed: CUDA error {err}")
