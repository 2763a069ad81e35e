"""Plain PyTorch version of the flash-attention kernel: attention with the
scores materialized. Ported from ``repro.kernels.flash_attention.ref``, with
GQA and ``kv_len`` added."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  kv_len: Optional[int] = None):
    """q: [B, H, S, D], k, v: [B, Hkv, S, D] -> [B, H, S, D].

    Query head h reads kv head h // (H // Hkv). Keys at positions >= kv_len
    never participate. Scores and softmax in f32; probabilities are cast to
    v's dtype before the PV product, as the reference does."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, S, D).float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= (pos[:, None] - pos[None, :]) < window
    if kv_len is not None:
        mask &= pos[None, :] < kv_len
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype), v)
    return out.reshape(B, H, S, D)
