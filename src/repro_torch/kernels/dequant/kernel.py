"""Binding of the Hopper dequant kernel (``csrc/dequant.cu``).

``dequant_fwd`` checks the tensors, then launches the kernel on PyTorch's
current stream (the calling thread's). It does not synchronise; a refused
launch raises here, a fault during the run shows at the next
synchronisation.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

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
