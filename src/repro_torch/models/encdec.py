"""Whisper-style encoder-decoder backbone, ported from
``repro.models.encdec``.

The audio front end (mel and two convolutions) is stubbed as in the
reference: the model takes precomputed frame embeddings [B, S_enc, d].
Encoder layers attend in both directions; decoder layers are causal
self-attention, cross-attention over the encoder's output, and a GELU MLP.

The encoder's attention and the decoder's prefill self-attention run the
flash-attention kernel (non-causal and causal); its training forward goes
through the kernel's autograd Function. Cross-attention stays plain
``dot_attention`` in prefill and decode, since its query length differs
from its key length and the kernel's q, k and v share one length; decode
self-attention stays plain as in every family. Each layer is its own
module (``enc_blocks.<i>``, ``dec_blocks.<i>``); the caches keep the
reference's stacked ``[layers, ...]`` layout. In ``train`` mode each layer
is recomputed in the backward, as the reference's ``jax.checkpoint`` of
its scan bodies does.
"""

from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import attention
from ..kernels.flash_attention.ops import local_heads
from .base import P, constrain
from .cache import LayerCache
from .config import ModelConfig
from .layers import (_proj, attention_decl, attn_out, attn_qkv,
                     cross_attention_decl, dot_attention, gelu_mlp,
                     gelu_mlp_decl, layernorm, layernorm_decl, sinusoidal_pos)
from .transformer import Ctx, decode_attention, prefill_put


def enc_block_decl(cfg: ModelConfig) -> dict:
    return {
        "ln_attn": layernorm_decl(cfg.d_model),
        "attn": attention_decl(cfg.d_model, cfg.n_heads, cfg.n_heads,
                               cfg.head_dim),
        "ln_mlp": layernorm_decl(cfg.d_model),
        "mlp": gelu_mlp_decl(cfg.d_model, cfg.d_ff),
    }


def dec_block_decl(cfg: ModelConfig) -> dict:
    return {
        "ln_self": layernorm_decl(cfg.d_model),
        "self_attn": attention_decl(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim),
        "ln_cross": layernorm_decl(cfg.d_model),
        "cross_attn": cross_attention_decl(cfg.d_model, cfg.n_heads,
                                           cfg.head_dim),
        "ln_mlp": layernorm_decl(cfg.d_model),
        "mlp": gelu_mlp_decl(cfg.d_model, cfg.d_ff),
    }


def encdec_decl(cfg: ModelConfig) -> dict:
    """The reference's declaration with ``enc_blocks`` and ``dec_blocks``
    unstacked into lists of per-layer declarations."""
    return {
        "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"), init="embed",
                   scale=0.02),
        "enc_blocks": [enc_block_decl(cfg)
                       for _ in range(cfg.encoder.n_layers)],
        "enc_norm": layernorm_decl(cfg.d_model),
        "dec_blocks": [dec_block_decl(cfg) for _ in range(cfg.n_layers)],
        "dec_norm": layernorm_decl(cfg.d_model),
    }


def _layers(body, x, per_layer, ctx: Ctx):
    """x through ``body(x, *args)`` for each ``args`` of ``per_layer``,
    each layer under a non-reentrant checkpoint in training. Sharded, the
    stream is held at ``("batch", None, None)`` after each layer, as the
    decoder-only models hold their residual."""
    rules = ctx.dist.rules if ctx.dist is not None else None
    for args in per_layer:
        if ctx.mode == "train":
            x = checkpoint(body, x, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(x, *args)
        if rules is not None:
            x = constrain(x, rules, ("batch", None, None))
    return x


def _enc_layer(h, p):
    xn = layernorm(p["ln_attn"], h)
    q, k, v = attn_qkv(p["attn"], xn, None, use_rope=False)
    h = h + attn_out(p["attn"], attention(q, k, v, causal=False))
    return h + gelu_mlp(p["mlp"], layernorm(p["ln_mlp"], h))


@functools.lru_cache(maxsize=8)
def _pos_emb(S: int, d: int, device: torch.device,
             dtype: torch.dtype) -> torch.Tensor:
    """``sinusoidal_pos(S, d)`` on ``device`` in ``dtype``, made once a
    shape, as the reference's jit folds it into a constant (NumPy's sines
    and cosines would cost the host each prefill). Read only."""
    return torch.as_tensor(sinusoidal_pos(S, d), device=device).to(dtype)


def encode(params, frames, cfg: ModelConfig, ctx: Ctx):
    """frames: [B, S_enc, d], the stubbed front end's output -> the
    encoder's normed output [B, S_enc, d]."""
    if isinstance(frames, FakeTensor):
        # a dry run's fake frames: a cached table belongs to another run's
        # fake mode, so the table is made anew (shapes only)
        pos = _pos_emb.__wrapped__(frames.shape[1], cfg.d_model,
                                   frames.device, frames.dtype)
    else:
        pos = _pos_emb(frames.shape[1], cfg.d_model, frames.device,
                       frames.dtype)
    x = frames + pos[None]
    x = _layers(_enc_layer, x, [(p,) for p in params["enc_blocks"]], ctx)
    return layernorm(params["enc_norm"], x)


def cross_kv(params, enc_out):
    """Cross-attention K and V of every decoder layer, each
    [L, B, S_enc, H, D]."""
    ks, vs = zip(*[(_proj(enc_out, p["cross_attn"]["wk"]),
                    _proj(enc_out, p["cross_attn"]["wv"]))
                   for p in params["dec_blocks"]])
    return torch.stack(ks), torch.stack(vs)


def _dec_layer(h, p, ek, ev, ctx: Ctx, cache):
    """One decoder layer; ``cache`` (this layer's ``k``/``v``) is filled
    (prefill) or extended (decode) in place."""
    cfg = ctx.cfg
    xn = layernorm(p["ln_self"], h)
    q, k, v = attn_qkv(p["self_attn"], xn, ctx.positions,
                       rope_theta=cfg.rope_theta)
    if ctx.mode == "decode":
        o = decode_attention(q, k, v, cache, ctx)
    else:
        o = attention(q, k, v, causal=True)
        if cache is not None:
            prefill_put(cache, k, v)
    h = h + attn_out(p["self_attn"], o)
    xn = layernorm(p["ln_cross"], h)
    qc = _proj(xn, p["cross_attn"]["wq"])
    h = h + attn_out(p["cross_attn"],
                     _cross_attention(qc, ek, ev, ctx.positions))
    return h + gelu_mlp(p["mlp"], layernorm(p["ln_mlp"], h))


def _cross_attention(q, ek, ev, q_pos):
    """Plain attention of q [B, T, H, D] over the encoder's K, V [B, S_enc,
    H, D] (cast to q's dtype), not causal. DTensors run on each rank's
    batch rows and heads, the frames whole (``local_heads``)."""
    def plain(ql, kl, vl):
        pos = torch.arange(kl.shape[1], device=kl.device)
        return dot_attention(ql, kl.to(ql.dtype), vl.to(ql.dtype), q_pos,
                             pos, causal=False)
    if isinstance(q, DTensor):
        return local_heads(plain, q, ek, ev)
    return plain(q, ek, ev)


def decode_blocks(params, x, cfg: ModelConfig, ctx: Ctx, enc_k, enc_v,
                  cache=None):
    """x: [B, T, d] token embeddings; enc_k, enc_v: [L, B, S_enc, H, D];
    ``cache``: the ``self_kv`` dict of [L, B, S, Hkv, D] tensors, updated
    in place (prefill, decode; training takes none) -> the decoder's
    normed output [B, T, d]."""
    if ctx.mode == "decode" and cache is None:
        raise ValueError("decode needs a cache")
    layers = [(p, enc_k[i], enc_v[i], ctx,
               None if cache is None else LayerCache(cache, i))
              for i, p in enumerate(params["dec_blocks"])]
    x = _layers(_dec_layer, x, layers, ctx)
    return layernorm(params["dec_norm"], x)


def encdec_cache(cfg: ModelConfig, batch: int, seq_len: int,
                 dtype=torch.bfloat16, device=None) -> dict:
    """``{"pos": 0, "self_kv": {"k", "v": [L, B, seq_len, Hkv, D]},
    "enc_k", "enc_v": [L, B, encoder.seq, H, D]}``, zeros, the position a
    0-d int64 tensor. A prefill
    fills ``enc_k``/``enc_v`` with its frames' cross K/V, and replaces
    them where the frames have another length, as the reference's does."""
    L = cfg.n_layers
    self_shape = (L, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    enc_shape = (L, batch, cfg.encoder.seq, cfg.n_heads, cfg.head_dim)
    k, v, ek, ev = (torch.zeros(shape, dtype=dtype, device=device)
                    for shape in (self_shape, self_shape, enc_shape,
                                  enc_shape))
    return {"pos": torch.zeros((), dtype=torch.int64, device=device),
            "self_kv": {"k": k, "v": v}, "enc_k": ek, "enc_v": ev}
