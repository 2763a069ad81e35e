"""Binding of the Hopper decode-attention kernel
(``csrc/decode_attention.cu``).

``decode_attention_fwd`` checks the tensors, sizes the splits of the valid
slots from the shapes alone (never from the position, which stays on the
card), allocates the scratch with ``torch.empty`` and launches the kernel's
two or three passes on PyTorch's current stream. It does not synchronise;
a refused launch raises here, a fault during the run shows at the next
synchronisation.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

HEAD_DIMS = (16, 64, 128, 256)              # the source's instances
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the grid aims at WAVES waves of BLOCKS_PER_SM blocks on each SM
WAVES, BLOCKS_PER_SM = 2, 4
MIN_SLOTS = 64                              # least slots a split takes


def _fn():
    fn = _build.load("decode_attention").lib.decode_attn_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 8
                       + [ctypes.c_int] * 9 + [ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def heads_per_block(G: int) -> int:
    """Query heads a block takes: 1 for MHA, else 8 of a kv head's G (the
    source's two instances)."""
    return 1 if G == 1 else 8


def splits(blocks: int, S: int, sms: int) -> int:
    """Splits of the slot range a (batch row, kv head, head chunk) block
    takes: enough for ``WAVES`` waves of ``BLOCKS_PER_SM`` blocks an SM,
    and none shorter than ``MIN_SLOTS`` slots of a full cache."""
    want = math.ceil(WAVES * BLOCKS_PER_SM * sms / blocks)
    return max(1, min(want, math.ceil(S / MIN_SLOTS), 65535))


@functools.lru_cache(maxsize=None)
def scale(D: int) -> float:
    """1 / sqrt(D) in f32, as the reference's ``/ math.sqrt(D)`` computes on
    the card (its reciprocal in f32, then a product)."""
    return float(torch.tensor(1.0, dtype=torch.float32)
                 / torch.tensor(math.sqrt(D), dtype=torch.float32))


def _vector_aligned(t: torch.Tensor, strides) -> bool:
    """4 elements of t at any of its rows start a 4-element vector."""
    return (t.stride(-1) == 1 and all(s % 4 == 0 for s in strides)
            and t.data_ptr() % (4 * t.element_size()) == 0)


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """q [B, 1, H, D] over the cache k, v [B, S, Hkv, D] at ``pos`` (a 0-d
    int64 tensor), all on one CUDA device -> [B, 1, H, D] in q's dtype. q
    and the cache in f32 or bf16, D in ``HEAD_DIMS``, H a multiple of Hkv;
    the head dims dense, the cache's other strides and its base whole
    4-element vectors."""
    B, one, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if one != 1 or k.shape != (B, S, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"decode attention takes q [B, 1, H, D] and k, v "
                         f"[B, S, Hkv, D]: got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if D not in HEAD_DIMS or H % Hkv:
        raise ValueError(f"decode attention takes D in {HEAD_DIMS} and H a "
                         f"multiple of Hkv: got D {D}, H {H}, Hkv {Hkv}")
    if q.dtype not in DTYPES or k.dtype not in DTYPES or v.dtype != k.dtype:
        raise ValueError(f"decode attention takes f32 or bf16 q and cache: "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    if not (dev.type == "cuda" and k.device == dev and v.device == dev
            and pos.device == dev):
        raise ValueError("q, the cache and pos must be on one CUDA device")
    if pos.dim() != 0 or pos.dtype != torch.int64:
        raise ValueError(f"pos must be a 0-d int64 tensor: got "
                         f"{pos.dtype} of shape {tuple(pos.shape)}")
    if q.stride(-1) != 1:
        raise ValueError("q's head dim must be dense")
    for t in (k, v):
        if not _vector_aligned(t, (t.stride(0), t.stride(1), t.stride(2))):
            raise ValueError("the cache's base and strides must hold whole "
                             "4-element vectors, its head dim dense")
    heads = heads_per_block(H // Hkv)
    nsplit = splits(B * Hkv * math.ceil(H // Hkv / heads), S,
                    _sms(dev.index if dev.index is not None
                         else torch.cuda.current_device()))
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=dev)
    scores = torch.empty((B, H, S), **f32)
    smax = torch.empty((B, H, nsplit), **f32)
    ssum = torch.empty((B, H, nsplit), **f32)
    part = torch.empty((nsplit, B, H, D) if nsplit > 1 else (1,), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                    out.data_ptr(), scores.data_ptr(), smax.data_ptr(),
                    ssum.data_ptr(), part.data_ptr(), q.stride(0),
                    q.stride(2), k.stride(0), k.stride(1), k.stride(2),
                    v.stride(0), v.stride(1), v.stride(2), B, H, Hkv, S, D,
                    nsplit, heads, DTYPES[k.dtype], DTYPES[q.dtype],
                    scale(D), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
    return out
