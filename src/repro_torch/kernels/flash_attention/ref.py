"""Plain PyTorch version of the flash-attention kernel: attention with the
scores materialized. Ported from ``repro.kernels.flash_attention.ref``, with
GQA and ``kv_len`` added; and its backward, ``attention_bwd_ref``, which the
reference leaves to XLA's autodiff (it has no backward kernel)."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _probs(qg, k, *, causal: bool, window: int, kv_len: Optional[int]):
    """Softmax probabilities [B, Hkv, G, S, S] of grouped queries qg
    [B, Hkv, G, S, D] against keys k [B, Hkv, S, D], in qg's dtype."""
    S, D = qg.shape[-2], qg.shape[-1]
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) / math.sqrt(D)
    pos = torch.arange(S, device=qg.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=qg.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= (pos[:, None] - pos[None, :]) < window
    if kv_len is not None:
        mask &= pos[None, :] < kv_len
    return torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Scores and softmax run in f32, or f64 for f64 inputs (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  kv_len: Optional[int] = None):
    """q: [B, H, S, D], k, v: [B, Hkv, S, D] -> [B, H, S, D].

    Query head h reads kv head h // (H // Hkv). Keys at positions >= kv_len
    never participate. Scores and softmax in f32; probabilities are cast to
    v's dtype before the PV product, as the reference does."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    acc = _acc(q.dtype)
    qg = q.reshape(B, Hkv, H // Hkv, S, D).to(acc)
    probs = _probs(qg, k.to(acc), causal=causal, window=window, kv_len=kv_len)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype), v)
    return out.reshape(B, H, S, D)


def attention_bwd_ref(q, k, v, out, dout, *, causal: bool = True,
                      window: int = 0, kv_len: Optional[int] = None):
    """Gradients (dq, dk, dv) of ``attention_ref`` at (q, k, v), given its
    output ``out`` and the output's gradient ``dout``; layouts as there.

    P is recomputed in f32; dV = Pᵀ·dO and dP = dO·Vᵀ in v's dtype (P cast
    to it, as in the forward); Δ = rowsum(dO ∘ O) from the saved output;
    dS = P ∘ (dP − Δ); dQ = dS·K / √D and dK = dSᵀ·Q / √D in f32. For GQA,
    dK and dV sum over the H / Hkv query heads of each kv head."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    acc = _acc(q.dtype)
    qg = q.reshape(B, Hkv, G, S, D).to(acc)
    kf = k.to(acc)
    probs = _probs(qg, kf, causal=causal, window=window, kv_len=kv_len)
    dog = dout.reshape(B, Hkv, G, S, D).to(v.dtype)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", probs.to(v.dtype), dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v).to(acc)
    delta = (dog.to(acc) * out.reshape(B, Hkv, G, S, D).to(acc)).sum(
        -1, keepdim=True)
    ds = probs * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) / math.sqrt(D)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) / math.sqrt(D)
    return dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
