"""Decoder-only assembly, ported from ``repro.models.transformer``.

Depth is segments of repeating block patterns. The reference stacks each
block's parameters over the repeat count and runs ``jax.lax.scan``; here the
layers are a ``ModuleList`` walked by a Python loop. Caches keep the
reference's stacked layout, a leading ``[layers, ...]`` axis on each of a
block's cache tensors, and are updated in place (a decode step writes one
slot instead of copying the cache).

Ported: every decoder block kind. ``full``/``global`` attention and the
windowed ``window``/``local`` attention, with ``swiglu``, ``gelu`` or
``moe`` MLPs and RMSNorm or LayerNorm; ``mla`` (``models/mla.py``);
``rglru`` (``models/rglru.py``, its parameters under ``"rec"``); ``rwkv``
(``models/rwkv6.py``, self-contained, mlp kind ``none``); in ``prefill``,
``decode`` and ``train`` modes. A windowed block's cache is a rolling buffer
of ``min(window, seq_len)`` slots: slot ``pos % S`` holds position ``pos``
(``_rolling_pos``). Prefill and training attention run the flash-attention
kernel with the block's window (training through its autograd Function,
with a plain backward); decode attention (one query over the cache, with
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
from . import mla as mla_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv6 as rwkv_mod
from .base import P
from .config import ModelConfig
from .layers import (attention_decl, attn_out, attn_qkv, dot_attention,
                     gelu_mlp, gelu_mlp_decl, layernorm, layernorm_decl,
                     rmsnorm, rmsnorm_decl, swiglu, swiglu_decl)

ATTN_KINDS = ("full", "window", "local", "global")
WINDOWED = ("window", "local")
# the block kinds whose prefill attends (one flash launch a layer)
ATTENDING = ATTN_KINDS + ("mla",)
MLP_KINDS = ("swiglu", "gelu", "moe")


def _check_block(block: str) -> tuple[str, str]:
    attn_kind, mlp_kind = block.split(":")
    if attn_kind == "rwkv":
        ok = mlp_kind == "none"      # self-contained (its own channel mix)
    else:
        ok = (attn_kind in ATTENDING + ("rglru",)
              and mlp_kind in MLP_KINDS + ("none",))
    if not ok:
        raise ValueError(f"unknown block {block!r}")
    return attn_kind, mlp_kind


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------


def _norm_decl(cfg: ModelConfig) -> dict:
    return rmsnorm_decl(cfg.d_model) if cfg.norm == "rmsnorm" \
        else layernorm_decl(cfg.d_model)


def _norm(cfg: ModelConfig, p, x):
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


def block_decl(cfg: ModelConfig, block: str) -> dict:
    attn_kind, mlp_kind = _check_block(block)
    if attn_kind == "rwkv":
        return rwkv_mod.rwkv_decl(cfg)
    decl: dict = {}
    if attn_kind == "rglru":
        decl["rec"] = rglru_mod.rglru_decl(cfg)
    else:
        decl["ln_attn"] = _norm_decl(cfg)
        decl["attn"] = mla_mod.mla_decl(cfg) if attn_kind == "mla" \
            else attention_decl(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, qk_norm=cfg.qk_norm,
                                fused=cfg.fused_qkv)
    if mlp_kind != "none":
        decl["ln_mlp"] = _norm_decl(cfg)
    if mlp_kind == "moe":
        decl["moe"] = moe_mod.moe_decl(cfg)
    elif mlp_kind == "gelu":
        decl["mlp"] = gelu_mlp_decl(cfg.d_model, cfg.d_ff)
    elif mlp_kind == "swiglu":
        decl["mlp"] = swiglu_decl(cfg.d_model, cfg.d_ff)
    return decl


def model_decl(cfg: ModelConfig) -> dict:
    """The reference's declaration with each stacked block unstacked into a
    list of per-layer declarations; an encoder-decoder's for a config with
    an ``encoder`` (``models/encdec.py``)."""
    if cfg.encoder is not None:
        from .encdec import encdec_decl      # encdec imports this module
        return encdec_decl(cfg)
    decl: dict = {
        "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"), init="embed",
                   scale=0.02),
        "final_norm": _norm_decl(cfg),
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


def cache_slots(cfg: ModelConfig, attn_kind: str, seq_len: int) -> int:
    """Slots of a block's cache: ``seq_len`` for full/global attention, a
    rolling ``min(window, seq_len)`` for window/local."""
    return min(cfg.window, seq_len) if attn_kind in WINDOWED else seq_len


def block_cache(cfg: ModelConfig, block: str, batch: int, seq_len: int,
                dtype=torch.bfloat16, device=None) -> dict:
    """One layer's cache, zeros: attention ``k``/``v`` [B, slots, Hkv, D]
    and MLA ``ckv``/``kr`` in ``dtype``; the RWKV (``S``, ``tm_prev``,
    ``cm_prev``) and RG-LRU (``h``, ``conv``) states in f32 whatever
    ``dtype`` is, as in the reference."""
    attn_kind, _ = _check_block(block)
    if attn_kind == "mla":
        return mla_mod.mla_cache_decl(cfg, batch, seq_len, dtype, device)
    if attn_kind == "rwkv":
        return rwkv_mod.rwkv_cache_decl(cfg, batch, device)
    if attn_kind == "rglru":
        return rglru_mod.rglru_cache_decl(cfg, batch, device)
    shape = (batch, cache_slots(cfg, attn_kind, seq_len), cfg.n_kv_heads,
             cfg.head_dim)
    return {n: torch.zeros(shape, dtype=dtype, device=device)
            for n in ("k", "v")}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """``{"pos": 0, "segments": [{"b{j}": {name: tensor}}]}``, each of a
    block's cache tensors (``block_cache``) stacked over the segment's
    repeats: ``[repeat, ...]``."""
    segs = []
    for blocks, rep in cfg.segments:
        seg = {}
        for j, b in enumerate(blocks):
            one = block_cache(cfg, b, batch, seq_len, dtype, device)
            seg[f"b{j}"] = {n: t[None].repeat((rep,) + (1,) * t.dim())
                            for n, t in one.items()}
        segs.append(seg)
    return {"pos": 0, "segments": segs}


def cache_capacity(cfg: ModelConfig, cache: dict) -> Optional[int]:
    """Positions the cache can hold: the slots of its full/global and MLA
    caches, or None (no limit) where every such block is windowed or
    recurrent, since rolling buffers and recurrent states never fill."""
    caps = []
    for si, (blocks, _) in enumerate(cfg.segments):
        for j, b in enumerate(blocks):
            kind = _check_block(b)[0]
            c = cache["segments"][si][f"b{j}"]
            if kind in ("full", "global"):
                caps.append(c["k"].shape[2])
            elif kind == "mla":
                caps.append(c["ckv"].shape[2])
    return min(caps) if caps else None


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Ctx:
    cfg: ModelConfig
    mode: str = "prefill"                       # prefill | decode | train
    positions: Optional[torch.Tensor] = None    # [T]; decode: [cache_pos]
    cache_pos: int = 0                          # decode: position of the token


def _rolling_pos(pos: int, W: int, device=None) -> torch.Tensor:
    """Absolute position held by each slot of a rolling buffer of W slots
    after position ``pos`` was written (negative: never written)."""
    slots = torch.arange(W, device=device)
    return pos - torch.remainder(pos - slots, W)


def attn_sublayer(p, x, kind: str, ctx: Ctx, cache):
    """The attention of a full/window/local/global block: x [B, T, d] ->
    its output [B, T, d], before the residual add. ``cache`` is filled
    (prefill) or extended (decode) in place."""
    cfg = ctx.cfg
    windowed = kind in WINDOWED
    window = cfg.window if windowed else 0
    xn = _norm(cfg, p["ln_attn"], x)
    q, k, v = attn_qkv(p["attn"], xn, ctx.positions,
                       rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                       n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                       head_dim=cfg.head_dim)
    if ctx.mode == "decode":
        pos = ctx.cache_pos
        ck, cv = cache["k"], cache["v"]
        S = ck.shape[1]
        slot = pos % S if windowed else pos
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        if windowed:
            kv_pos = _rolling_pos(pos, S, x.device)
            kv_valid = kv_pos >= 0
        else:
            kv_pos = torch.arange(S, device=x.device)
            kv_valid = kv_pos <= pos
        o = dot_attention(q, ck.to(x.dtype), cv.to(x.dtype), ctx.positions,
                          kv_pos, causal=True, window=window,
                          kv_valid=kv_valid[None, :].expand(x.shape[0], S))
    else:
        o = attention(q, k, v, causal=True, window=window)
        if cache is not None:
            T, S = x.shape[1], cache["k"].shape[1]
            for c, new in ((cache["k"], k), (cache["v"], v)):
                if windowed and T > S:
                    # the last S positions, position t in slot t % S
                    c.copy_(torch.roll(new[:, T - S:], (T - S) % S, dims=1))
                else:
                    c[:, :T] = new.to(c.dtype)
                    c[:, T:] = 0
    return attn_out(p["attn"], o)


def apply_block(p, x, block: str, ctx: Ctx, cache=None):
    """One block; ``cache`` (this layer's) is filled (prefill) or extended
    (decode) in place. Returns (x, aux): the MoE block's load-balancing
    loss (a 0-d f32 tensor), 0.0 for the others."""
    cfg = ctx.cfg
    attn_kind, mlp_kind = block.split(":")
    if attn_kind == "rwkv":
        return rwkv_mod.rwkv_block(
            p, x, cache, cfg=cfg,
            use_chunked=cfg.rwkv_chunked and ctx.mode != "decode"), 0.0
    if attn_kind == "mla":
        x = x + mla_mod.mla_attention(p["attn"], _norm(cfg, p["ln_attn"], x),
                                      ctx.positions, cfg, cache=cache,
                                      cache_pos=ctx.cache_pos)
    elif attn_kind == "rglru":
        x = rglru_mod.rglru_block(p["rec"], x, cache, cfg=cfg)
    else:
        x = x + attn_sublayer(p, x, attn_kind, ctx, cache)
    if mlp_kind == "none":
        return x, 0.0
    xn = _norm(cfg, p["ln_mlp"], x)
    if mlp_kind == "moe":
        y, aux = moe_mod.moe_block(p["moe"], xn, cfg)
        return x + y, aux
    mlp = gelu_mlp if mlp_kind == "gelu" else swiglu
    return x + mlp(p["mlp"], xn), 0.0


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
    """x: [B, T, d] embedded inputs -> (final-normed hidden [B, T, d], the
    sum of the blocks' aux losses). ``cache`` is updated in place (prefill,
    decode; training takes none).

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
    aux_total = 0.0
    for si, (blocks, rep) in enumerate(cfg.segments):
        seg_params = params["segments"][si]
        seg_cache = cache["segments"][si] if cache is not None else None
        for i in range(rep):
            for j, block in enumerate(blocks):
                c = None
                if seg_cache is not None:
                    c = {n: t[i] for n, t in seg_cache[f"b{j}"].items()}
                p = seg_params[f"b{j}"][i]
                if ctx.mode == "train":
                    x, aux = checkpoint(apply_block, p, x, block, ctx,
                                        use_reentrant=False,
                                        preserve_rng_state=False)
                else:
                    x, aux = apply_block(p, x, block, ctx, c)
                aux_total = aux_total + aux
    return _norm(cfg, params["final_norm"], x), aux_total
