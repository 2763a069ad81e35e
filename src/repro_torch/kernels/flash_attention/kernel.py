"""Binding of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention_fwd`` checks the tensors, then launches the kernel on
PyTorch's current stream. It does not synchronise; a refused launch raises
here, a fault during the run shows at the next synchronisation.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
D_MAX = 128
_INT_MAX = 2**31 - 1


def _fn():
    fn = _build.load("flash_attention").lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 21
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q, k, v, out, *, causal: bool, window: int,
                        kv_len: int) -> None:
    """q, out: [B, S, H, D]; k, v: [B, S, Hkv, D]; CUDA tensors of one dtype
    (float32 or bfloat16), innermost dim contiguous, any other strides."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if not all(x.is_cuda and x.device == q.device for x in (k, v, out)):
        raise ValueError("q, k, v and out must be on one CUDA device")
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in (k, v, out)):
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}, "
                         f"{out.dtype}: need one of {list(_DTYPES)}")
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or out.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} out {tuple(out.shape)}")
    if not 0 < D <= D_MAX or H % Hkv != 0 or S == 0 or B == 0:
        raise ValueError(f"need 0 < D <= {D_MAX}, H % Hkv == 0, S, B > 0; "
                         f"got D={D} H={H} Hkv={Hkv} S={S} B={B}")
    strides = []
    for x in (q, k, v, out):
        sb, ss, sh, sd = x.stride()
        if sd != 1:
            raise ValueError("the head dim must be contiguous (stride 1)")
        strides += [sb, ss, sh]
    if max(strides) > _INT_MAX:
        raise ValueError("strides beyond 32 bits")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    _DTYPES[q.dtype], B, H, Hkv, S, D, *strides,
                    int(causal), int(window), int(kv_len), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
