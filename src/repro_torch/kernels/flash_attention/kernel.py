"""Binding of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention_fwd`` checks the tensors, chooses the body (the one place
that does), then launches it on PyTorch's current stream. It does not
synchronise; a refused launch raises here, a fault during the run shows at
the next synchronisation.

The source has three bodies. ``wgmma`` (TMA copies, wgmma products) takes
the bf16 calls with D <= 256 (``WGMMA_D_MAX``: its shared memory and
registers hold no wider row) that meet TMA's rules; ``mma`` (mma.sync) every
bf16 call; ``simt`` every f32 call. ``simt`` multiplies in f32 FMA on the
CUDA cores (no TF32), bound by the 67 TFLOP/s FFMA peak: register-tiled
products (a thread a 4 x 4 tile of scores), 64 query rows a block, K and V
through a ``cp.async`` ring, 16-byte copies where every base is 16-byte
aligned and every stride a multiple of 4 elements, 4-byte copies otherwise
(the C entry point chooses). ``mma`` and ``simt`` take any D > 0: past 256 a
block computes a slice of 256 output columns, scoring over the whole of D.
``body="auto"`` takes the first of these that takes the call; nothing falls
back from one body to another.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = {"simt": 0, "mma": 1, "wgmma": 2}   # the C entry point's codes
WGMMA_D_MAX = 256    # csrc/flash_attention.cu W_DMAX
_INT_MAX = 2**31 - 1


def _fn():
    fn = _build.load("flash_attention").lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 22
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def takes(body: str, dtype: torch.dtype, D: int, strides, ptrs) -> bool:
    """Whether ``body`` takes a call. ``strides``: the batch, sequence and
    head strides (elements) of q, k, v and out; ``ptrs``: their addresses.
    ``wgmma`` needs TMA's rules: bf16, 16-byte-aligned addresses, strides
    that are positive multiples of 8 elements (16 bytes), D a multiple of 8
    up to ``WGMMA_D_MAX``. The others take any D > 0."""
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}: one of {list(BODIES)}")
    if D <= 0:
        return False
    if body == "simt":
        return dtype == torch.float32
    if dtype != torch.bfloat16:
        return False
    if body == "mma":
        return True
    return (D <= WGMMA_D_MAX and D % 8 == 0 and all(p % 16 == 0 for p in ptrs)
            and all(s > 0 and s % 8 == 0 for s in strides))


def select_body(dtype: torch.dtype, D: int, strides, ptrs) -> str:
    """The body ``"auto"`` launches: wgmma where it takes the call, else
    mma for bf16, simt for f32 (so mma or simt for D > 256)."""
    for body in ("wgmma", "mma", "simt"):
        if takes(body, dtype, D, strides, ptrs):
            return body
    raise ValueError(f"no body takes dtype {dtype} with D={D} (the kernel "
                     f"takes D > 0)")


def flash_attention_fwd(q, k, v, out, *, causal: bool, window: int,
                        kv_len: int, body: str = "auto") -> str:
    """q, out: [B, S, H, D]; k, v: [B, S, Hkv, D]; CUDA tensors of one dtype
    (float32 or bfloat16), innermost dim contiguous, any other strides.
    Returns the name of the body launched."""
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
    if D <= 0 or H % Hkv != 0 or S == 0 or B == 0:
        raise ValueError(f"need D > 0, H % Hkv == 0, S, B > 0; "
                         f"got D={D} H={H} Hkv={Hkv} S={S} B={B}")
    strides = []
    for x in (q, k, v, out):
        sb, ss, sh, sd = x.stride()
        if sd != 1:
            raise ValueError("the head dim must be contiguous (stride 1)")
        strides += [sb, ss, sh]
    if max(strides) > _INT_MAX:
        raise ValueError("strides beyond 32 bits")
    ptrs = [x.data_ptr() for x in (q, k, v, out)]
    if body == "auto":
        body = select_body(q.dtype, D, strides, ptrs)
    elif not takes(body, q.dtype, D, strides, ptrs):
        raise ValueError(f"body {body!r} does not take dtype {q.dtype}, "
                         f"D={D}, strides {strides}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(*ptrs, _DTYPES[q.dtype], B, H, Hkv, S, D, *strides,
                    int(causal), int(window), int(kv_len), BODIES[body],
                    stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd ({body}) launch failed: "
                           f"CUDA error {err}")
    return body
