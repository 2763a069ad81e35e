"""Binding of the Hopper page-unpack kernel (``csrc/page_unpack.cu``).

``page_unpack_fwd`` checks the tensors, then launches the kernel on
PyTorch's current stream (the calling thread's). It does not synchronise; a
refused launch raises here, a fault during the run shows at the next
synchronisation.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .staging import DESC_DTYPE


def _fn():
    fn = _build.load("page_unpack").lib.page_unpack_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _aligned_bytes(t: torch.Tensor) -> bool:
    return (t.dtype == torch.uint8 and t.dim() == 1 and t.is_contiguous()
            and t.data_ptr() % 16 == 0)


def page_unpack_fwd(staging: torch.Tensor, n_pages: int, n_blocks: int,
                    out: torch.Tensor) -> None:
    """staging: uint8[nbytes] of ``staging.pack_pages`` (descriptors, then
    the pages' regions); out: uint8 bytes that hold every page's values at
    its ``out_offset``; both contiguous, 16-byte aligned, on one CUDA
    device. ``staging`` may be a part of ``out``: the pages' outputs must
    not overlap it."""
    if not (staging.is_cuda and out.is_cuda and staging.device == out.device):
        raise ValueError("staging and out must be on one CUDA device")
    if not (_aligned_bytes(staging) and _aligned_bytes(out)):
        raise ValueError("staging and out must be contiguous, 16-byte-aligned "
                         "uint8 vectors")
    if staging.numel() < n_pages * DESC_DTYPE.itemsize:
        raise ValueError(f"staging of {staging.numel()} bytes holds no "
                         f"{n_pages} descriptors")
    with torch.cuda.device(staging.device):
        stream = torch.cuda.current_stream(staging.device).cuda_stream
        err = _fn()(staging.data_ptr(), n_pages, n_blocks, out.data_ptr(),
                    stream)
    if err != 0:
        raise RuntimeError(f"page_unpack launch failed: CUDA error {err}")
