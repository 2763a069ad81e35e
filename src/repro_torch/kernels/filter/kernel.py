"""Binding of the Hopper range-filter kernel (``csrc/filter.cu``).

``range_mask_fwd`` checks the tensors, then launches the kernel on
PyTorch's current stream (the calling thread's). It does not synchronise; a
refused launch raises here, a fault during the run shows at the next
synchronisation.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build


def _fn():
    fn = _build.load("filter").lib.range_mask_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def range_mask_fwd(cols: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   out: torch.Tensor) -> None:
    """cols: f32[C, N] at any strides; lo, hi: f32[C] contiguous; out:
    uint8[N] contiguous; all on one CUDA device."""
    if cols.dim() != 2:
        raise ValueError(f"cols must be [C, N], got shape {tuple(cols.shape)}")
    C, N = cols.shape
    if not all(t.is_cuda and t.device == cols.device for t in (cols, lo, hi, out)):
        raise ValueError("cols, lo, hi and out must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in (cols, lo, hi)) \
            or out.dtype != torch.uint8:
        raise ValueError(f"dtypes {cols.dtype}, {lo.dtype}, {hi.dtype}, "
                         f"{out.dtype}: need float32 cols/lo/hi, uint8 out")
    if lo.shape != (C,) or hi.shape != (C,) or out.shape != (N,):
        raise ValueError(f"shapes lo {tuple(lo.shape)} hi {tuple(hi.shape)} "
                         f"out {tuple(out.shape)} for cols {tuple(cols.shape)}")
    if not (lo.is_contiguous() and hi.is_contiguous() and out.is_contiguous()):
        raise ValueError("lo, hi and out must be contiguous")
    stride_c, stride_n = cols.stride()
    vec4 = (stride_n == 1 and (stride_c % 4 == 0 or C == 1)
            and cols.data_ptr() % 16 == 0 and out.data_ptr() % 4 == 0)
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        err = _fn()(cols.data_ptr(), stride_c, stride_n, C, N, lo.data_ptr(),
                    hi.data_ptr(), out.data_ptr(), int(vec4), stream)
    if err != 0:
        raise RuntimeError(f"range_mask launch failed: CUDA error {err}")
