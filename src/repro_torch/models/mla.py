"""Multi-head Latent Attention (DeepSeek-V2 style, as MiniCPM3 uses it),
ported from ``repro.models.mla``.

The cache holds only the compressed latent (``kv_lora_rank``) and the shared
RoPE key, ``{"ckv": [B, S, r], "kr": [B, S, dr]}``, updated in place.

Prefill and training expand the latents to full keys and values and run the
flash-attention kernel, as the port's other prefills do (the reference
computes this attention plain). The kernel takes one head dim for q, k and
v: q and k are ``nope ‖ rope`` (``dn + dr``), so V is zero-padded from
``dv`` to ``dn + dr`` and the padded output columns dropped, which is exact;
the kernel's scale ``1/sqrt(dn + dr)`` is the reference's. Decode runs the
absorbed form over the compressed cache (the query projected into latent
space) in plain PyTorch, as the reference leaves it to XLA. Its value
product runs in the cache's dtype, as the reference's does; the port then
rounds it to the compute dtype before ``wo``. The reference does not: at
a bf16 compute dtype over an f32 cache its output stays f32 and its layer
scan raises on the changed carry dtype, so it serves no such model.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import attention
from .base import P
from .cache import put, put_slot
from .layers import NEG_INF, _proj, attn_out, rmsnorm, rmsnorm_decl, rope


def mla_decl(cfg) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    return {
        "wq_a": P((d, m.q_lora_rank), ("embed", None)),
        "q_norm": rmsnorm_decl(m.q_lora_rank),
        "wq_b": P((m.q_lora_rank, H, dn + dr), (None, "heads", None)),
        "wkv_a": P((d, m.kv_lora_rank + dr), ("embed", None)),
        "kv_norm": rmsnorm_decl(m.kv_lora_rank),
        "wkv_b": P((m.kv_lora_rank, H, dn + dv), (None, "heads", None)),
        "wo": P((H, dv, d), ("heads", None, "embed")),
    }


def _project_q(p, x, positions, cfg):
    dn = cfg.mla.qk_nope_head_dim
    q = _proj(rmsnorm(p["q_norm"], _proj(x, p["wq_a"])), p["wq_b"])
    return q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)


def _latent_kv(p, x, positions, cfg):
    r = cfg.mla.kv_lora_rank
    ckv_full = _proj(x, p["wkv_a"])
    ckv = rmsnorm(p["kv_norm"], ckv_full[..., :r])
    k_rope = rope(ckv_full[..., None, r:], positions, cfg.rope_theta)[..., 0, :]
    return ckv, k_rope


def mla_attention(p, x, positions, cfg, cache=None, cache_pos=None):
    """x [B, T, d] -> out [B, T, d]. ``cache`` ({"ckv", "kr"} of this layer)
    is filled from position 0 (prefill, T > 1) or extended at ``cache_pos``
    (decode, T == 1: a 0-d tensor on the device), in place."""
    m = cfg.mla
    B, T, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q_nope, q_rope = _project_q(p, x, positions, cfg)
    ckv_new, kr_new = _latent_kv(p, x, positions, cfg)

    if cache is not None and T == 1:
        # -- absorbed decode over the compressed cache --
        put_slot(cache, "ckv", ckv_new, cache_pos)
        put_slot(cache, "kr", kr_new, cache_pos)
        ckv, kr = cache["ckv"], cache["kr"]
        S = ckv.shape[1]
        w_k = p["wkv_b"][..., :dn].to(x.dtype)              # [r, H, dn]
        w_v = p["wkv_b"][..., dn:].to(x.dtype)              # [r, H, dv]
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_k)
        scores = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), ckv.float())
                  + torch.einsum("bqhd,bsd->bhqs", q_rope.float(), kr.float())
                  ) / math.sqrt(dn + dr)
        valid = torch.arange(S, device=x.device) <= cache_pos
        scores = torch.where(valid, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        ctx_lat = torch.einsum("bhqs,bsr->bqhr", probs.to(ckv.dtype), ckv)
        o = torch.einsum("bqhr,rhd->bqhd", ctx_lat,
                         w_v.to(ctx_lat.dtype)).to(x.dtype)
    else:
        # -- train / prefill: expand the latents, flash attention at dn+dr --
        kv = _proj(ckv_new, p["wkv_b"])
        k = torch.cat([kv[..., :dn],
                       kr_new[:, :, None, :].expand(B, T, H, dr)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        if dv > dn + dr:
            raise ValueError(f"v_head_dim {dv} exceeds the qk head dim "
                             f"{dn + dr}: V is padded up to it")
        v = F.pad(kv[..., dn:], (0, dn + dr - dv))
        o = attention(q, k, v, causal=True)[..., :dv]
        if cache is not None:
            for name, new in (("ckv", ckv_new), ("kr", kr_new)):
                put(cache, name, new, (slice(None), slice(0, T)))
                put(cache, name, 0, (slice(None), slice(T, None)))
    return attn_out(p, o)


def mla_cache_decl(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "kr": torch.zeros((batch, max_seq, m.qk_rope_head_dim),
                              dtype=dtype, device=device)}
