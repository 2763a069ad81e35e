"""Decoder-only assembly, ported from ``repro.models.transformer``.

Depth is segments of repeating block patterns. The reference stacks each
block's parameters over the repeat count and runs ``jax.lax.scan``; here the
layers are a ``ModuleList`` walked by a Python loop. Caches keep the
reference's stacked layout, a leading ``[layers, ...]`` axis on each of a
block's cache tensors, and are updated in place (a decode step writes one
slot instead of copying the cache) through ``models.cache``: a layer's
``LayerCache`` reads its slice, ``put`` (prefill) and ``put_slot``
(decode) write into the stack (into each rank's local shard for a
sharded cache).

Ported: every decoder block kind. ``full``/``global`` attention and the
windowed ``window``/``local`` attention, with ``swiglu``, ``gelu`` or
``moe`` MLPs and RMSNorm or LayerNorm; ``mla`` (``models/mla.py``);
``rglru`` (``models/rglru.py``, its parameters under ``"rec"``); ``rwkv``
(``models/rwkv6.py``, self-contained, mlp kind ``none``); in ``prefill``,
``decode`` and ``train`` modes. A windowed block's cache is a rolling buffer
of ``min(window, seq_len)`` slots: slot ``pos % S`` holds position ``pos``
(``_rolling_pos``). A decode step reads its position from the cache's 0-d
int64 tensor on the device (``Ctx.pos``) for RoPE, the cache write and the
valid slots, so that it launches the same ops at every position. Prefill
and training attention run the flash-attention kernel with the block's
window (training through its autograd Function, with a plain backward);
decode attention (one query over the cache) runs the decode-attention
kernel on CUDA, which reads the cache once, in its own dtype, and only
its valid slots, where the reference leaves it to XLA as plain
``dot_attention``; on the CPU it stays that plain version. Training
rematerialises each layer, as the reference's ``jax.checkpoint`` of its
scan body does.

Sharded (a ``Ctx.dist`` with a mesh, the parameters DTensors): the
residual stream is held at ``("batch", "seq", None)`` before the layers
and after each repeat of a segment's pattern, as the reference constrains
it; the embedding gather runs on each rank's batch rows against the whole
table (``_sharded_gather``); attention launches the kernel on local
shards (``kernels.flash_attention.attention``), decode attention its
own kernel (plain on the CPU) on the same local shards (``local_heads``);
the MoE and RWKV blocks take ``dist`` (``models/moe.py``,
``models/rwkv6.py``). Every other op is DTensor's own, 3-D products on
flat rows (``layers._mm``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..kernels.decode_attention import decode_attention as cache_attention
from ..kernels.flash_attention import attention
from ..kernels.flash_attention.ops import local_heads
from . import mla as mla_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv6 as rwkv_mod
from ..distributed.placement import grad_placements, placements
from ..obs import trace as _trace
from .base import P, constrain
from .cache import LayerCache, put, put_slot
from .config import ModelConfig
from .layers import (_mm, attention_decl, attn_out, attn_qkv, dot_attention,
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
    """``{"pos": 0, "segments": [{"b{j}": {name: tensor}}]}``, the position a
    0-d int64 tensor, each of a block's cache tensors (``block_cache``)
    stacked over the segment's repeats: ``[repeat, ...]``."""
    segs = []
    for blocks, rep in cfg.segments:
        seg = {}
        for j, b in enumerate(blocks):
            one = block_cache(cfg, b, batch, seq_len, dtype, device)
            seg[f"b{j}"] = {n: t[None].repeat((rep,) + (1,) * t.dim())
                            for n, t in one.items()}
        segs.append(seg)
    return {"pos": torch.zeros((), dtype=torch.int64, device=device),
            "segments": segs}


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
    positions: Optional[torch.Tensor] = None    # [T]; decode: [pos]
    dist: object = None                         # distributed.Dist, or None
    pos: Optional[torch.Tensor] = None          # decode: 0-d, the token's


def _rolling_pos(pos, W: int, device=None) -> torch.Tensor:
    """Absolute position held by each slot of a rolling buffer of W slots
    after position ``pos`` (an int or a 0-d tensor) was written (negative:
    never written)."""
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
        o = decode_attention(q, k, v, cache, ctx, window=window)
    else:
        o = attention(q, k, v, causal=True, window=window)
        if cache is not None:
            prefill_put(cache, k, v, windowed)
    return attn_out(p["attn"], o)


def prefill_put(cache, k, v, windowed: bool = False) -> None:
    """A prompt's k, v [B, T, Hkv, D] into a layer's cache of S slots:
    positions 0..T-1 and zeros after them; a rolling (``windowed``) cache
    shorter than the prompt keeps the last S positions, position t in slot
    t % S."""
    T, S = k.shape[1], cache["k"].shape[1]
    for name, new in (("k", k), ("v", v)):
        if windowed and T > S:
            # positions T-S .. T-s0-1 to slots s0 .., the rest to slots 0 ..
            s0 = (T - S) % S
            put(cache, name, new[:, T - S:T - s0], (slice(None), slice(s0, S)))
            put(cache, name, new[:, T - s0:], (slice(None), slice(0, s0)))
        else:
            put(cache, name, new, (slice(None), slice(0, T)))
            put(cache, name, 0, (slice(None), slice(T, None)))


def decode_attention(q, k, v, cache, ctx: Ctx, *, window: int = 0):
    """One decode step over a layer's cache of S slots, a rolling buffer
    where ``window``: k, v [B, 1, Hkv, D] written in place at the slot of
    the position ``ctx.pos`` (``pos % S`` rolling), then q [B, 1, H, D]
    over the slots written -> [B, 1, H, D]: on CUDA the decode-attention
    kernel (``kernels.decode_attention``, the cache read in its own dtype
    and rounded to q's in registers), elsewhere plain (``dot_attention``,
    the cache cast to q's dtype), as the reference leaves it outside any
    kernel; the two compute one function. DTensors run on each rank's
    batch rows and query heads, the cache's sequence whole
    (``local_heads``)."""
    S, pos = cache["k"].shape[1], ctx.pos
    slot = torch.remainder(pos, S) if window else pos
    put_slot(cache, "k", k, slot)
    put_slot(cache, "v", v, slot)
    if q.device.type == "cuda":
        def attend(ql, kl, vl):
            return cache_attention(ql, kl, vl, pos, window=window)
    else:
        if window:
            kv_pos = _rolling_pos(pos, S, q.device)
            kv_valid = kv_pos >= 0
        else:
            kv_pos = torch.arange(S, device=q.device)
            kv_valid = kv_pos <= pos

        def attend(ql, kl, vl):
            valid = kv_valid[None, :].expand(ql.shape[0], kl.shape[1])
            return dot_attention(ql, kl.to(ql.dtype), vl.to(ql.dtype),
                                 ctx.positions, kv_pos, causal=True,
                                 window=window, kv_valid=valid)
    if isinstance(q, DTensor):
        return local_heads(attend, q, cache["k"], cache["v"])
    return attend(q, cache["k"], cache["v"])


def apply_block(p, x, block: str, ctx: Ctx, cache=None):
    """One block; ``cache`` (this layer's) is filled (prefill) or extended
    (decode) in place. Returns (x, aux): the MoE block's load-balancing
    loss (a 0-d f32 tensor), 0.0 for the others. The attention sublayer of
    every kind, its cache write included, runs in a ``layer.attn`` span
    (an RWKV layer whole: its channel mix is inside the same block), the
    MoE block in a ``layer.moe`` span."""
    cfg = ctx.cfg
    attn_kind, mlp_kind = block.split(":")
    with _trace.span("layer.attn", cat="model"):
        if attn_kind == "rwkv":
            return rwkv_mod.rwkv_block(
                p, x, cache, cfg=cfg, dist=ctx.dist,
                use_chunked=cfg.rwkv_chunked and ctx.mode != "decode"), 0.0
        if attn_kind == "mla":
            x = x + mla_mod.mla_attention(
                p["attn"], _norm(cfg, p["ln_attn"], x), ctx.positions, cfg,
                cache=cache, cache_pos=ctx.pos)
        elif attn_kind == "rglru":
            x = rglru_mod.rglru_block(p["rec"], x, cache, cfg=cfg)
        else:
            x = x + attn_sublayer(p, x, attn_kind, ctx, cache)
    if mlp_kind == "none":
        return x, 0.0
    xn = _norm(cfg, p["ln_mlp"], x)
    if mlp_kind == "moe":
        with _trace.span("layer.moe", cat="model"):
            y, aux = moe_mod.moe_block(p["moe"], xn, cfg, ctx.dist)
        return x + y, aux
    mlp = gelu_mlp if mlp_kind == "gelu" else swiglu
    return x + mlp(p["mlp"], xn), 0.0


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _sharded_gather(embed: DTensor, tokens: torch.Tensor, rules):
    """``embed[tokens]`` for a sharded table and a whole batch of token ids:
    the table is gathered whole on every rank, which looks up its own
    batch rows (``("batch", None, None)``). The table's gradient is then a
    partial sum over the batch axes."""
    mesh = embed.device_mesh
    rep = (Replicate(),) * mesh.ndim
    tok = placements(rules.spec_for(("batch", None)), mesh, tokens.shape)
    out = placements(rules.spec_for(("batch", None, None)), mesh,
                     (*tokens.shape, embed.shape[1]))
    gather = local_map(lambda e, t: e[t], out_placements=[*out],
                       in_placements=(rep, tok),
                       in_grad_placements=(grad_placements(rep, out), tok),
                       device_mesh=mesh, redistribute_inputs=True)
    return gather(embed, DTensor.from_local(tokens, mesh, rep))


def embed_tokens(params, tokens, cfg: ModelConfig, dtype, rules=None):
    """Token ids [B, T] -> [B, T, d] in ``dtype``; a DTensor table needs
    the ``rules`` that place the batch."""
    emb = params["embed"]
    if isinstance(emb, DTensor):
        if rules is None:
            raise ValueError("a sharded embedding needs the sharding rules")
        x = _sharded_gather(emb, tokens, rules).to(dtype)
    else:
        x = emb[tokens].to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return x


def logits_fn(params, x, cfg: ModelConfig):
    """x [..., d] -> logits [..., vocab]; sharded, on the flat rows of x
    (``layers._mm``), so the logits keep x's batch sharding."""
    if cfg.tie_embeddings:
        return _mm(x, params["embed"].to(x.dtype).T)
    return _mm(x, params["lm_head"].to(x.dtype))


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
    rules = ctx.dist.rules if ctx.dist is not None else None
    if rules is not None:
        x = constrain(x, rules, ("batch", "seq", None))
    aux_total = 0.0
    for si, (blocks, rep) in enumerate(cfg.segments):
        seg_params = params["segments"][si]
        seg_cache = cache["segments"][si] if cache is not None else None
        for i in range(rep):
            for j, block in enumerate(blocks):
                c = None
                if seg_cache is not None:
                    c = LayerCache(seg_cache[f"b{j}"], i)
                p = seg_params[f"b{j}"][i]
                if ctx.mode == "train":
                    x, aux = checkpoint(apply_block, p, x, block, ctx,
                                        use_reentrant=False,
                                        preserve_rng_state=False)
                else:
                    x, aux = apply_block(p, x, block, ctx, c)
                aux_total = aux_total + aux
            if rules is not None:
                x = constrain(x, rules, ("batch", "seq", None))
    return _norm(cfg, params["final_norm"], x), aux_total
