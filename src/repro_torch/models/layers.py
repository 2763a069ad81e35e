"""Transformer layers as plain functions on tensors, ported from
``repro.models.layers``: RMSNorm, LayerNorm, RoPE and the sinusoidal
position table, GQA attention (full, sliding-window, local) and the
cross-attention declaration, SwiGLU and GELU MLPs.

Parameters are dict-like (a plain dict of tensors or a ``ParamTree``) and
keep the JAX layouts: ``wq [d, H, D]``, ``wo [H, D, d]``, ``w_gate [d, ff]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from .base import P

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_decl(d: int) -> dict:
    return {"scale": P((d,), (None,), init="ones")}


def rmsnorm(p, x, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)


def layernorm_decl(d: int) -> dict:
    return {"scale": P((d,), (None,), init="ones"),
            "bias": P((d,), (None,), init="zeros")}


def layernorm(p, x, eps: float = 1e-5):
    """Statistics, scale and bias in f32; the result in x's dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float = 10000.0):
    """x: [..., S, H, D]; positions: [..., S] (broadcastable)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions.float()[..., None] * freqs   # [..., S, half]
    cos = torch.cos(angles)[..., None, :]           # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq: int, d: int) -> np.ndarray:
    """[seq, d] f32: sin then cos of pos / 10000^(2i/d), i < d/2."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    angles = pos / np.power(10000.0, 2 * i / d)
    return np.concatenate([np.sin(angles), np.cos(angles)],
                          axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_decl(d: int, n_heads: int, n_kv: int, head_dim: int,
                   qk_norm: bool = False, fused: bool = False) -> dict:
    if fused:
        decl = {
            "wqkv": P((d, (n_heads + 2 * n_kv) * head_dim), ("embed", "heads")),
            "wo": P((n_heads, head_dim, d), ("heads", None, "embed")),
        }
    else:
        decl = {
            "wq": P((d, n_heads, head_dim), ("embed", "heads", None)),
            "wk": P((d, n_kv, head_dim), ("embed", "kv_heads", None)),
            "wv": P((d, n_kv, head_dim), ("embed", "kv_heads", None)),
            "wo": P((n_heads, head_dim, d), ("heads", None, "embed")),
        }
    if qk_norm:
        decl["q_norm"] = rmsnorm_decl(head_dim)
        decl["k_norm"] = rmsnorm_decl(head_dim)
    return decl


def _mask(q_pos, kv_pos, causal: bool, window: int):
    """[Sq, Skv] additive mask from position vectors."""
    m = torch.ones((q_pos.shape[-1], kv_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= kv_pos[None, :]
    if window > 0:
        m &= (q_pos[:, None] - kv_pos[None, :]) < window
    return torch.where(m, 0.0, NEG_INF)


def dot_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                  kv_valid=None):
    """GQA attention with the scores materialized.
    q: [B,Sq,H,D]  k,v: [B,Skv,Hkv,D]  q_pos: [Sq]  kv_pos: [Skv]
    kv_valid: optional [B,Skv] bool (cache slots filled)."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg.float(),
                          k.float()) / math.sqrt(D)
    scores = scores + _mask(q_pos, kv_pos, causal, window)
    if kv_valid is not None:
        scores = scores + torch.where(kv_valid, 0.0,
                                      NEG_INF)[:, None, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


class _Flat(torch.autograd.Function):
    """A weight viewed as a matrix, ``[prod(shape[:split]),
    prod(shape[split:])]``. For a DTensor the gradient is placed as the
    weight's flat image (its ``Shard(0)`` and ``Shard(split)`` mesh dims
    kept, the others replicated) before it is viewed back: DTensor's
    backward may otherwise shard the flat dim across the split. A dim of
    size 1 sharded (over a mesh axis of size 1: the same data) is first
    replicated, as DTensor cannot flatten it sharded (recurrentgemma-9b's
    one kv head on a (1, 1) mesh)."""

    @staticmethod
    def forward(ctx, w, split):
        ctx.shape, ctx.split = w.shape, split
        if isinstance(w, DTensor):
            plc = tuple(Replicate() if isinstance(p, Shard)
                        and w.shape[p.dim] == 1 else p for p in w.placements)
            if plc != tuple(w.placements):
                w = w.redistribute(w.device_mesh, plc)
            ctx.flat = tuple(Shard(0) if p == Shard(0) else
                             Shard(1) if p == Shard(split) else Replicate()
                             for p in w.placements)
        return w.reshape(math.prod(w.shape[:split]), -1)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.flat:
            g = g.redistribute(g.device_mesh, ctx.flat)
        return g.reshape(ctx.shape), None


def flat(w, split: int = 1):
    """``w`` as a matrix split after dim ``split`` (``_Flat`` for a
    DTensor, a plain reshape otherwise)."""
    if isinstance(w, DTensor):
        return _Flat.apply(w, split)
    return w.reshape(math.prod(w.shape[:split]), -1)


class _Rows(torch.autograd.Function):
    """x [*lead, d] as flat rows [N, d] (x sharded on its leading and last
    dims at most). A DTensor's gradient is placed as x before it is split
    back: DTensor's backward may otherwise shard a dim that the views
    upstream split unevenly (whisper-base's 8 heads over model = 16)."""

    @staticmethod
    def forward(ctx, x):
        ctx.lead = tuple(x.shape[:-1])
        last = Shard(x.ndim - 1)
        ctx.plc = tuple(Shard(1) if p == last else p for p in x.placements)
        return x.reshape(-1, x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.plc:
            g = g.redistribute(g.device_mesh, ctx.plc)
        return g.reshape(*ctx.lead, g.shape[-1])


class _Unflat(torch.autograd.Function):
    """Flat rows y [N, n] split back to [*lead, n]. For a DTensor the
    gradient is placed as the split y (its row and column shardings on the
    first and last dims, replicated elsewhere) before it is flattened:
    DTensor's backward may hand it sharded over rows that the mesh does not
    divide (3 over data = 2), which it cannot flatten."""

    @staticmethod
    def forward(ctx, y, lead):
        ctx.plc = tuple(Shard(len(lead)) if p == Shard(1) else p
                        for p in y.placements)
        return y.reshape(*lead, y.shape[-1])

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.plc:
            g = g.redistribute(g.device_mesh, ctx.plc)
        return g.reshape(-1, g.shape[-1]), None


def _mm(x, w):
    """x [..., d] @ w [d, n]. A DTensor x of 3 or more dims multiplies as
    flat rows [N, d]: first placed with its leading (batch) dim's sharding
    where the mesh divides it and its last dim's, replicated elsewhere (a
    sharded sequence gathered, partial sums reduced), and the product
    placed with x's row sharding and its own column sharding, replicated
    elsewhere, before it is split back (``_Rows``, ``_Unflat``: their
    gradients placed alike). DTensor may otherwise
    shard the flat rows over an axis that does not divide them and then
    fail to split them (whisper-base's 2 x 16 frames over model = 3). A
    plain x times a DTensor w is x replicated."""
    if isinstance(w, DTensor) and not isinstance(x, DTensor):
        x = DTensor.from_local(x, w.device_mesh,
                               (Replicate(),) * w.device_mesh.ndim,
                               run_check=False)
    if not isinstance(x, DTensor) or x.ndim == 2:
        return x @ w
    mesh, last = x.device_mesh, Shard(x.ndim - 1)
    xp = tuple(p if p == last or (p == Shard(0)
                                  and x.shape[0] % mesh.size(i) == 0)
               else Replicate() for i, p in enumerate(x.placements))
    if tuple(x.placements) != xp:
        x = x.redistribute(mesh, xp)
    y = _Rows.apply(x) @ w
    want = tuple(Shard(0) if px == Shard(0) else
                 py if py == Shard(1) else Replicate()
                 for px, py in zip(x.placements, y.placements))
    if tuple(y.placements) != want:
        y = y.redistribute(mesh, want)
    return _Unflat.apply(y, tuple(x.shape[:-1]))


def _proj(x, w):
    """x [..., d] times w [d, *out] -> [..., *out], in x's dtype. For
    DTensors the flat product is first placed as the split needs it:
    sharded where x shards its leading (batch) dim or w its first output
    dim, which the split keeps outermost, and replicated elsewhere (DTensor
    may otherwise shard the flat dim across the split, e.g. replicated GQA
    kv heads over the model axis)."""
    y = _mm(x, flat(w.to(x.dtype)))
    if isinstance(y, DTensor) and len(w.shape) > 2:
        want = tuple(
            Shard(0) if px == Shard(0) else
            Shard(y.ndim - 1) if pw == Shard(1) else Replicate()
            for px, pw in zip(x.placements, w.placements))
        if tuple(y.placements) != want:
            y = y.redistribute(y.device_mesh, want)
    return y.unflatten(-1, w.shape[1:])


def attn_qkv(p, x, positions, *, rope_theta=10000.0, qk_norm=False,
             use_rope=True, n_heads=None, n_kv=None, head_dim=None):
    """Project x [B, S, d] to q [B,S,H,D], k, v [B,S,Hkv,D], with optional
    RoPE and qk-norm."""
    if "wqkv" in p:
        qkv = x @ p["wqkv"].to(x.dtype)
        H, Hkv, D = n_heads, n_kv, head_dim
        q = qkv[..., : H * D].unflatten(-1, (H, D))
        k = qkv[..., H * D: (H + Hkv) * D].unflatten(-1, (Hkv, D))
        v = qkv[..., (H + Hkv) * D:].unflatten(-1, (Hkv, D))
    else:
        q = _proj(x, p["wq"])
        k = _proj(x, p["wk"])
        v = _proj(x, p["wv"])
    if qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if use_rope:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v


def attn_out(p, o):
    """o [B, S, H, D] -> [B, S, d] through wo [H, D, d]."""
    return _mm(o.flatten(-2), flat(p["wo"].to(o.dtype), 2))


def cross_attention_decl(d: int, n_heads: int, head_dim: int) -> dict:
    return attention_decl(d, n_heads, n_heads, head_dim)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_decl(d: int, ff: int) -> dict:
    return {"w_gate": P((d, ff), ("embed", "ff")),
            "w_up": P((d, ff), ("embed", "ff")),
            "w_down": P((ff, d), ("ff", "embed"))}


def swiglu(p, x):
    g = _mm(x, p["w_gate"].to(x.dtype))
    u = _mm(x, p["w_up"].to(x.dtype))
    return _mm(F.silu(g) * u, p["w_down"].to(x.dtype))


def gelu_mlp_decl(d: int, ff: int) -> dict:
    return {"w_up": P((d, ff), ("embed", "ff")),
            "b_up": P((ff,), ("ff",), init="zeros"),
            "w_down": P((ff, d), ("ff", "embed")),
            "b_down": P((d,), (None,), init="zeros")}


def gelu_mlp(p, x):
    """``jax.nn.gelu``'s default is the tanh approximation, so this is too
    (PyTorch's default is erf)."""
    h = _mm(x, p["w_up"].to(x.dtype)) + p["b_up"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return _mm(h, p["w_down"].to(x.dtype)) + p["b_down"].to(x.dtype)
