"""Public wrapper of the dequant kernel.

``dequant`` takes the JAX wrapper's ``[R, C]`` codes and ``[C]`` scale and
zero (``repro.kernels.dequant.ops``) as tensors and returns ``[R, C]`` of
``out_dtype`` on their device. The dtype of ``scale`` and ``zero`` sets the
arithmetic: float32 as the TPU kernel, float64 as the storage layer's
``dequantize`` (NumPy's bits). A CUDA tensor launches the kernel (and adds
one to ``dequant.launches``); a CPU tensor takes the plain version,
``dequant_ref``. Nothing falls back from the kernel, and nothing is padded:
the kernel masks the ragged edge itself.
"""

from __future__ import annotations

import threading

import torch

from ... import resolve_device
from .kernel import ARITH_TYPES, OUT_TYPES, Q_TYPES, dequant_fwd
from .ref import dequant_ref


_launch_lock = threading.Lock()


def _count_launch() -> None:
    """One launch more; the read path launches from a thread pool."""
    with _launch_lock:
        dequant.launches += 1


def dequant(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
            out_dtype=torch.bfloat16, *, device=None) -> torch.Tensor:
    """q: int8/uint8/int16[R, C] (affine) or uint16[R, C] (bf16 bits), any
    strides; scale, zero: f32 or f64 [C] -> out_dtype[R, C] (f32 or bf16).

    ``device`` defaults to ``cuda`` (raises where CUDA is absent); the
    tensors must lie on it."""
    dev = resolve_device(device)
    if any(t.device.type != dev.type for t in (q, scale, zero)):
        raise ValueError(f"tensors on {q.device}, {scale.device}, "
                         f"{zero.device}; asked for {dev}")
    if q.dim() != 2 or scale.shape != (q.shape[1],) \
            or zero.shape != scale.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} scale "
                         f"{tuple(scale.shape)} zero {tuple(zero.shape)}")
    if q.dtype not in Q_TYPES or scale.dtype not in ARITH_TYPES \
            or zero.dtype != scale.dtype or out_dtype not in OUT_TYPES:
        raise ValueError(f"dtypes q {q.dtype}, scale {scale.dtype}, zero "
                         f"{zero.dtype}, out {out_dtype}")
    if dev.type == "cpu":
        return dequant_ref(q, scale, zero, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"no dequant path for device {dev}")
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if out.numel():
        dequant_fwd(q, scale.contiguous(), zero.contiguous(), out)
        _count_launch()
    return out


dequant.launches = 0
