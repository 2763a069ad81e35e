"""Public wrapper of the dequant kernel.

``dequant`` takes the JAX wrapper's ``[R, C]`` codes and ``[C]`` scale and
zero (``repro.kernels.dequant.ops``) as tensors and returns ``[R, C]`` of
``out_dtype`` on their device. The dtype of ``scale`` and ``zero`` sets the
arithmetic: float32 as the TPU kernel, float64 as the storage layer's
``dequantize`` (NumPy's bits). A CUDA tensor launches the kernel (and adds
one to ``dequant.launches``); a CPU tensor takes the plain version,
``dequant_ref``. Nothing falls back from the kernel, and nothing is padded:
the kernel masks the ragged edge itself.

``dequant_columns`` is the read path's entry: a list of 1-D host code
columns, each with its float64 ``(scale, zero)``, to float32 host columns,
in one launch of the column-list body. It packs the columns into one
staging buffer (``staging.pack_columns``; page-locked for the card), then
on ``cuda`` makes one copy to the card, one launch (``dequant_packed``,
counted in ``dequant_packed.launches``), one copy back into page-locked
memory and one synchronisation. On ``cpu`` the same buffer goes through the
body's plain version, ``dequant_packed_ref``.
"""

from __future__ import annotations

import threading
from typing import Sequence

import torch

from ... import resolve_device
from .kernel import (ARITH_TYPES, OUT_TYPES, Q_TYPES, dequant_fwd,
                     dequant_packed_fwd)
from .ref import dequant_packed_ref, dequant_ref
from .staging import pack_columns


_launch_lock = threading.Lock()


def _count_launch(fn=None) -> None:
    """One launch more of ``fn`` (default ``dequant``); the read path
    launches from a thread pool."""
    fn = dequant if fn is None else fn
    with _launch_lock:
        fn.launches += 1


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


def dequant_packed(staging: torch.Tensor, n_cols: int, n_tiles: int,
                   n_out: int) -> torch.Tensor:
    """The column-list body: a staging buffer of ``pack_columns`` (moved to
    its device) -> float32[n_out] on that device, each column at its
    ``out_offset``. A CUDA tensor launches the kernel, a CPU tensor takes
    ``dequant_packed_ref``."""
    if staging.device.type == "cpu":
        return dequant_packed_ref(staging, n_cols, n_out)
    if staging.device.type != "cuda":
        raise ValueError(f"no dequant path for device {staging.device}")
    out = torch.empty(n_out, dtype=torch.float32, device=staging.device)
    if n_tiles:
        dequant_packed_fwd(staging, n_cols, n_tiles, out)
        _count_launch(dequant_packed)
    return out


dequant_packed.launches = 0


def dequant_columns(codes: Sequence, params: Sequence[tuple[float, float]],
                    *, device=None) -> list[torch.Tensor]:
    """1-D code columns on the host (NumPy arrays or CPU tensors: int8,
    uint8, int16 affine, or uint16 bf16 bits) and their float64
    ``(scale, zero)`` -> float32 CPU tensors, one a column, equal bit for
    bit to ``core.quantization.dequantize``. The columns are views of one
    fresh output buffer, which nothing reuses while they live.

    ``device`` (default ``cuda``, raises where CUDA is absent) is where the
    body runs: the kernel on ``cuda``, its plain version on ``cpu``."""
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no dequant path for device {dev}")
    if not len(codes):
        return []
    cuda = dev.type == "cuda"
    packed = pack_columns(codes, params, pin=cuda)
    out = dequant_packed(packed.buffer.to(dev, non_blocking=True),
                         packed.n_cols, packed.n_tiles, packed.n_out)
    if cuda:
        host = torch.empty(packed.n_out, dtype=torch.float32, pin_memory=True)
        host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(out.device).synchronize()
        out = host
    return [out[o:o + r] for o, r in zip(packed.out_offsets, packed.rows)]
