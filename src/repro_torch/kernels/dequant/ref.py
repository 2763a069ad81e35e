"""Plain PyTorch version of the dequant kernel (Bullion §2.4).

Ported from ``repro.kernels.dequant.ref``, with the arithmetic type taken
from ``scale`` and ``zero``: float32 as the TPU kernel computes, float64 as
the storage layer computes (``core.quantization.dequantize``). The multiply
and the add are separate operations, never fused, so float64 gives NumPy's
bits. ``dequant_packed_ref`` is the plain version of the column-list body:
it reads the same staging buffer (``staging.py``) and dequantizes each
column with ``dequant_ref`` in float64.
"""

from __future__ import annotations

import torch

from .staging import CODE_DTYPES, descriptors


def to_bf16(f: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16, round to nearest even; a NaN becomes the quiet
    NaN with its sign (0x7FC0 | sign), as XLA and ml_dtypes give it.
    PyTorch's own cast gives other NaN bits, and not the same ones on every
    path."""
    rounded = f.to(torch.bfloat16).view(torch.int16)
    quiet = torch.where(f.view(torch.int32) < 0, -64, 0x7FC0)  # -64: 0xFFC0
    return torch.where(torch.isnan(f), quiet.to(torch.int16),
                       rounded).view(torch.bfloat16)


def dequant_ref(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """q: int8/uint8/int16[R, C] (affine) or uint16[R, C] (raw bf16 bits);
    scale/zero: f32 or f64 [C]. Returns a contiguous out_dtype[R, C]."""
    if q.dtype == torch.uint16:      # stored bf16 bit pattern -> float, exact
        # the int16 view times 2**16 is the pattern shifted up, with no
        # overflow (PyTorch has no shifts on unsigned types on the CPU)
        f = (q.view(torch.int16).to(torch.int32) * 65536).view(torch.float32)
    else:
        f = (q.to(scale.dtype) * scale + zero).to(torch.float32)
    f = f.contiguous()
    return to_bf16(f) if out_dtype == torch.bfloat16 else f.to(out_dtype)


def dequant_packed_ref(staging: torch.Tensor, n_cols: int,
                       n_out: int) -> torch.Tensor:
    """staging: uint8 buffer of ``staging.pack_columns`` -> float32[n_out]
    on its device, each column at its ``out_offset`` (gaps read 0)."""
    out = torch.zeros(n_out, dtype=torch.float32, device=staging.device)
    for d in descriptors(staging, n_cols):
        code = CODE_DTYPES[int(d["q_type"])]
        off, rows, at = int(d["code_offset"]), int(d["rows"]), int(d["out_offset"])
        q = staging[off:off + rows * code.itemsize].view(
            getattr(torch, code.name)).view(-1, 1)
        params = torch.tensor([d["scale"], d["zero"]], dtype=torch.float64,
                              device=staging.device)
        out[at:at + rows] = dequant_ref(q, params[:1], params[1:],
                                        torch.float32).view(-1)
    return out
