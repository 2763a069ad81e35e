"""Model zoo entry point, ported from ``repro.models.zoo``:
``build(cfg) -> Model`` with ``loss`` (training), ``init_cache``,
``prefill`` and ``decode_step`` (serving), for decoder-only models and
the encoder-decoder (``models/encdec.py``), whose batches carry ``frames``.

``Model`` is an ``nn.Module`` that holds its parameters; their names are the
reference's key paths with a layer index after the block, e.g.
``segments.0.b0.3.attn.wq``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import encdec as encdec_mod
from . import transformer as tf
from .base import ParamTree, init_tree, param_count
from .config import ModelConfig


def as_device_tensor(x, device) -> torch.Tensor:
    """A tensor or array (numpy, or anything ``np.asarray`` takes) on
    ``device``; arrays are copied."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x))
    return x.to(device)


def _xent(logits, labels):
    """Mean next-token cross-entropy: f32 log-softmax, the label's entry."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0].mean()


class Model(ParamTree):
    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        """Parameters initialised from ``seed`` on ``device`` (default
        ``cuda``) in ``dtype``, with the reference's init scheme."""
        dev = resolve_device(device)
        decl = tf.model_decl(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        super().__init__(init_tree(decl, gen, dev, dtype))
        self.cfg = cfg
        self.decl = decl
        self.is_encdec = cfg.encoder is not None

    @property
    def n_params(self) -> int:
        return param_count(self.decl)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    # -- training ---------------------------------------------------------------
    def _frames(self, batch: dict) -> torch.Tensor:
        return as_device_tensor(batch["frames"], self.device).to(self._dtype())

    def loss(self, batch: dict):
        """batch: {"tokens": [B, S+1]} (a tensor or array of token ids), and
        "frames" [B, S_enc, d] for an encoder-decoder -> the mean next-token
        loss plus ``aux_loss_weight`` times the MoE blocks' load-balancing
        loss, a 0-d f32 tensor with a graph back to the parameters that
        require grad. Each layer is recomputed in the backward
        (``transformer.forward``, ``encdec``)."""
        cfg = self.cfg
        dt = self._dtype()
        params = self
        if cfg.cast_params_once and dt != torch.float32:
            # one cast of the f32 master weights before the layers (the
            # reference's, for its all-gathers); grads flow back through it
            params = self.as_tree(
                lambda p: p.to(dt) if p.dtype == torch.float32 else p)
        tokens = as_device_tensor(batch["tokens"], self.device).long()
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        T = inputs.shape[1]
        ctx = tf.Ctx(cfg=cfg, mode="train",
                     positions=torch.arange(T, device=tokens.device))
        x = tf.embed_tokens(params, inputs, cfg, dt)
        if self.is_encdec:
            enc_out = encdec_mod.encode(params, self._frames(batch), cfg, ctx)
            ek, ev = encdec_mod.cross_kv(params, enc_out)
            x = encdec_mod.decode_blocks(params, x, cfg, ctx, ek, ev)
            return _xent(tf.logits_fn(params, x, cfg), labels)
        x, aux = tf.forward(params, x, cfg, ctx)
        return (_xent(tf.logits_fn(params, x, cfg), labels)
                + cfg.aux_loss_weight * aux)

    # -- serving ----------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16) -> dict:
        if self.is_encdec:
            return encdec_mod.encdec_cache(self.cfg, batch, seq_len, dtype,
                                           device=self.device)
        return tf.init_cache(self.cfg, batch, seq_len, dtype, device=self.device)

    def _capacity(self, cache: dict):
        if self.is_encdec:
            return cache["self_kv"]["k"].shape[2]
        return tf.cache_capacity(self.cfg, cache)

    def prefill(self, batch: dict, cache: dict):
        """Fill ``cache`` (in place) from a prompt ``batch["tokens"]`` [B, T]
        (and, for an encoder-decoder, ``batch["frames"]`` [B, S_enc, d]);
        returns (last-token logits [B, V], cache). The prompt must fit the
        full/global caches; rolling (windowed) caches keep its last
        positions. An encoder-decoder's ``enc_k``/``enc_v`` take the
        frames' cross K/V in the cache's dtype: copied into the cache's
        tensors for frames of ``encoder.seq`` rows, in place of them for
        frames of another length, as the reference's replacement does."""
        tokens = batch["tokens"]
        T = tokens.shape[1]
        cap = self._capacity(cache)
        if cap is not None and T > cap:
            raise ValueError(f"prompt of {T} tokens exceeds the cache "
                             f"({cap} positions)")
        ctx = tf.Ctx(cfg=self.cfg, mode="prefill",
                     positions=torch.arange(T, device=tokens.device))
        x = tf.embed_tokens(self, tokens, self.cfg, self._dtype())
        if self.is_encdec:
            enc_out = encdec_mod.encode(self, self._frames(batch), self.cfg,
                                        ctx)
            ek, ev = encdec_mod.cross_kv(self, enc_out)
            for name, new in (("enc_k", ek), ("enc_v", ev)):
                if cache[name].shape == new.shape:
                    cache[name].copy_(new)
                else:
                    cache[name] = new.to(cache[name].dtype)
            x = encdec_mod.decode_blocks(self, x, self.cfg, ctx, ek, ev,
                                         cache=cache["self_kv"])
        else:
            x, _ = tf.forward(self, x, self.cfg, ctx, cache=cache)
        cache["pos"] = T
        return tf.logits_fn(self, x[:, -1], self.cfg), cache

    def decode_step(self, cache: dict, tokens):
        """tokens: [B, 1] at position ``cache["pos"]`` -> (logits [B, V],
        cache), the cache extended in place. Raises once the full/global
        caches are full; a model whose attention is all windowed decodes
        without end."""
        pos = cache["pos"]
        cap = self._capacity(cache)
        if cap is not None and pos >= cap:
            raise ValueError(f"cache full at position {pos}")
        ctx = tf.Ctx(cfg=self.cfg, mode="decode", cache_pos=pos,
                     positions=torch.arange(pos, pos + 1, device=tokens.device))
        x = tf.embed_tokens(self, tokens, self.cfg, self._dtype())
        if self.is_encdec:
            x = encdec_mod.decode_blocks(self, x, self.cfg, ctx,
                                         cache["enc_k"], cache["enc_v"],
                                         cache=cache["self_kv"])
        else:
            x, _ = tf.forward(self, x, self.cfg, ctx, cache=cache)
        cache["pos"] = pos + 1
        return tf.logits_fn(self, x[:, 0], self.cfg), cache


def build(cfg: ModelConfig, device=None, dtype=None, seed: int = 0) -> Model:
    """A ``Model`` on ``device`` (default ``cuda``; raises where CUDA is
    absent) with parameters in ``dtype`` (default float32)."""
    return Model(cfg, device=device, dtype=dtype or torch.float32, seed=seed)
