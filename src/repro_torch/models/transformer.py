"""Decoder-only assembly, ported from ``repro.models.transformer``.

Depth is segments of repeating block patterns. The reference stacks each
block's parameters over the repeat count and runs ``jax.lax.scan``; here the
layers are a ``ModuleList`` walked by a Python loop. Caches keep the
reference's stacked layout, ``[layers, B, S, Hkv, D]``, and are updated in
place (a decode step writes one slot instead of copying the cache).

Ported: ``full``/``global`` attention with ``swiglu`` MLPs, in ``prefill``,
``decode`` and ``train`` modes. Prefill and training attention run the
flash-attention kernel (training through its autograd Function, with a
plain backward); decode attention (one query over the cache, with
``kv_valid``) stays plain PyTorch, as the reference leaves it to XLA
outside any kernel. Training rematerialises each layer, as the reference's
``jax.checkpoint`` of its scan body does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import attention
from .base import P
from .config import ModelConfig
from .layers import (attention_decl, attn_out, attn_qkv, dot_attention,
                     rmsnorm, rmsnorm_decl, swiglu, swiglu_decl)

_LATER = "the 'other block families' slice of ROADMAP.md"


def _check_block(cfg: ModelConfig, block: str) -> None:
    attn_kind, mlp_kind = block.split(":")
    if attn_kind not in ("full", "global") or mlp_kind != "swiglu":
        raise NotImplementedError(f"block {block!r} is not ported yet: {_LATER}")
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet: {_LATER}")


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------


def block_decl(cfg: ModelConfig, block: str) -> dict:
    _check_block(cfg, block)
    return {
        "ln_attn": rmsnorm_decl(cfg.d_model),
        "attn": attention_decl(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, qk_norm=cfg.qk_norm,
                               fused=cfg.fused_qkv),
        "ln_mlp": rmsnorm_decl(cfg.d_model),
        "mlp": swiglu_decl(cfg.d_model, cfg.d_ff),
    }


def model_decl(cfg: ModelConfig) -> dict:
    """The reference's declaration with each stacked block unstacked into a
    list of per-layer declarations."""
    if cfg.encoder is not None:
        raise NotImplementedError(f"encoder-decoder is not ported yet: {_LATER}")
    decl: dict = {
        "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"), init="embed",
                   scale=0.02),
        "final_norm": rmsnorm_decl(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        decl["lm_head"] = P((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    decl["segments"] = [
        {f"b{j}": [block_decl(cfg, b) for _ in range(rep)]
         for j, b in enumerate(blocks)}
        for blocks, rep in cfg.segments
    ]
    return decl


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """``{"pos": 0, "segments": [{"b{j}": {"k", "v"}}]}`` with k, v of shape
    ``[repeat, batch, seq_len, Hkv, D]``, zeros."""
    segs = []
    for blocks, rep in cfg.segments:
        seg = {}
        for j, b in enumerate(blocks):
            _check_block(cfg, b)
            shape = (rep, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
            seg[f"b{j}"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                            "v": torch.zeros(shape, dtype=dtype, device=device)}
        segs.append(seg)
    return {"pos": 0, "segments": segs}


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Ctx:
    cfg: ModelConfig
    mode: str = "prefill"                       # prefill | decode | train
    positions: Optional[torch.Tensor] = None    # [T]; decode: [cache_pos]
    cache_pos: int = 0                          # decode: slot of the new token


def _attn_block(p, x, ctx: Ctx, cache):
    cfg = ctx.cfg
    xn = rmsnorm(p["ln_attn"], x)
    q, k, v = attn_qkv(p["attn"], xn, ctx.positions,
                       rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                       n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                       head_dim=cfg.head_dim)
    if ctx.mode == "decode":
        pos = ctx.cache_pos
        ck, cv = cache["k"], cache["v"]
        ck[:, pos] = k[:, 0].to(ck.dtype)
        cv[:, pos] = v[:, 0].to(cv.dtype)
        S = ck.shape[1]
        kv_pos = torch.arange(S, device=x.device)
        kv_valid = (kv_pos <= pos)[None, :].expand(x.shape[0], S)
        o = dot_attention(q, ck.to(x.dtype), cv.to(x.dtype), ctx.positions,
                          kv_pos, causal=True, kv_valid=kv_valid)
    else:
        o = attention(q, k, v, causal=True)
        if cache is not None:
            T = x.shape[1]
            for c, new in ((cache["k"], k), (cache["v"], v)):
                c[:, :T] = new.to(c.dtype)
                c[:, T:] = 0
    return x + attn_out(p["attn"], o)


def apply_block(p, x, ctx: Ctx, cache=None):
    """One ``full:swiglu`` block; ``cache`` ({"k", "v"} of this layer) is
    filled (prefill) or extended (decode) in place."""
    x = _attn_block(p, x, ctx, cache)
    return x + swiglu(p["mlp"], rmsnorm(p["ln_mlp"], x))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens, cfg: ModelConfig, dtype):
    x = params["embed"][tokens].to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return x


def logits_fn(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return x @ params["lm_head"].to(x.dtype)


def forward(params, x, cfg: ModelConfig, ctx: Ctx, cache=None):
    """x: [B, T, d] embedded inputs -> final-normed hidden [B, T, d].
    ``cache`` is updated in place (prefill, decode; training takes none).

    In ``train`` mode each layer runs under a non-reentrant ``checkpoint``:
    its activations are dropped after the forward and recomputed in the
    backward (so its attention kernel launches twice a step). The
    reference's ``remat_policy="dots"`` saves the products' outputs
    instead of recomputing them; here it checkpoints the whole layer too,
    which gives the same numbers and spends the recompute instead of the
    memory."""
    if ctx.mode not in ("prefill", "decode", "train"):
        raise ValueError(f"unknown mode {ctx.mode!r}")
    if ctx.mode == "decode" and cache is None:
        raise ValueError("decode needs a cache")
    if ctx.mode == "train" and cache is not None:
        raise ValueError("training takes no cache")
    for si, (blocks, rep) in enumerate(cfg.segments):
        seg_params = params["segments"][si]
        seg_cache = cache["segments"][si] if cache is not None else None
        for i in range(rep):
            for j in range(len(blocks)):
                c = None
                if seg_cache is not None:
                    c = {n: seg_cache[f"b{j}"][n][i] for n in ("k", "v")}
                p = seg_params[f"b{j}"][i]
                if ctx.mode == "train":
                    x = checkpoint(apply_block, p, x, ctx, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = apply_block(p, x, ctx, c)
    return rmsnorm(params["final_norm"], x)
