"""Binding of the Hopper BP32 unpack kernel (``csrc/bitunpack.cu``).

``bitunpack_fwd`` checks the tensors, then launches the kernel on PyTorch's
current stream (the calling thread's). It does not synchronise; a refused
launch raises here, a fault during the run shows at the next
synchronisation.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build


def _fn():
    fn = _build.load("bitunpack").lib.bitunpack_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def bitunpack_fwd(planes: torch.Tensor, width: int, out: torch.Tensor) -> None:
    """planes: uint32[G, width] at any strides, G * 32 >= len(out); out:
    uint32[n] contiguous; both on one CUDA device."""
    if planes.dim() != 2 or planes.shape[1] != width or not 1 <= width <= 32:
        raise ValueError(f"planes {tuple(planes.shape)} for width {width}: "
                         "need [G, width], 1 <= width <= 32")
    if not (planes.is_cuda and out.is_cuda and planes.device == out.device):
        raise ValueError("planes and out must be on one CUDA device")
    if planes.dtype != torch.uint32 or out.dtype != torch.uint32:
        raise ValueError(f"dtypes {planes.dtype}, {out.dtype}: need uint32")
    if out.dim() != 1 or not out.is_contiguous() \
            or out.numel() > 32 * planes.shape[0]:
        raise ValueError(f"out {tuple(out.shape)} for {planes.shape[0]} "
                         "groups: need a contiguous [n], n <= 32 * G")
    stride_g, stride_w = planes.stride()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = _fn()(planes.data_ptr(), stride_g, stride_w, width, out.numel(),
                    out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bitunpack launch failed: CUDA error {err}")
