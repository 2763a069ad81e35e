"""Model zoo entry point, ported from ``repro.models.zoo``:
``build(cfg) -> Model`` with ``loss`` (training), ``init_cache``,
``prefill`` and ``decode_step`` (serving), for decoder-only models and
the encoder-decoder (``models/encdec.py``), whose batches carry ``frames``.

``Model`` is an ``nn.Module`` that holds its parameters; their names are the
reference's key paths with a layer index after the block, e.g.
``segments.0.b0.3.attn.wq``.

With a ``dist`` (``distributed.make_dist(mesh)``) each parameter is a
DTensor on the mesh, placed by ``spec_tree(decl, dist.rules, mesh)``, and
``loss``, ``prefill`` and ``decode_step`` run sharded, inside
``sharded_ops()``. ``init_cache`` then makes each cache tensor a DTensor
placed by ``launch.dryrun.cache_specs`` (the reference's dry run lowers
its sharded serving with the same specs); the blocks write into it
through ``models.cache``, into each rank's local shards.

A cache holds its decode position as the reference's does, a 0-d int64
tensor on the model's device, ``cache["pos"]`` (plain beside a sharded
cache's DTensors), which ``prefill`` sets and each decode step advances.
``Model.advance`` counts it on the host for the "cache full" check alone.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map
from torch.distributed.tensor import zeros as sharded_zeros

from .. import resolve_device
from ..distributed.placement import placements
from ..distributed.sharding import sharded_ops
from . import encdec as encdec_mod
from . import moe as moe_mod
from . import transformer as tf
from .base import (ParamTree, ShardingRules, abstract_tree, init_tree,
                   param_count, spec_tree)
from .cache import put
from .config import ModelConfig


def as_device_tensor(x, device) -> torch.Tensor:
    """A tensor or array (numpy, or anything ``np.asarray`` takes) on
    ``device``; arrays are copied."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x))
    return x.to(device)


def _pick(logp, labels):
    return logp.gather(-1, labels[..., None])[..., 0]


def _xent(logits, labels):
    """Mean next-token cross-entropy: f32 log-softmax, the label's entry.
    Sharded logits pick the label's entry under ``local_map``, on each
    rank's rows with the labels placed alike: DTensor's gather would take
    a replicated index, and its backward would allocate the
    log-probabilities' whole global shape on every rank."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if isinstance(logp, DTensor):
        mesh = logp.device_mesh
        rows = tuple(p if p == Shard(0) else Replicate()
                     for p in logp.placements)
        labels = DTensor.from_local(labels, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
        return -local_map(_pick, out_placements=[*rows],
                          in_placements=(rows, rows),
                          in_grad_placements=(rows, rows), device_mesh=mesh,
                          redistribute_inputs=True)(logp, labels).mean()
    return -_pick(logp, labels).mean()


def _distribute(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor placed by its spec."""
    if isinstance(tree, dict):
        return {k: _distribute(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, list):
        return [_distribute(t, s, mesh) for t, s in zip(tree, specs)]
    return distribute_tensor(tree, mesh, placements(specs, mesh))


class Model(ParamTree):
    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 dist=None):
        """Parameters initialised from ``seed`` on ``device`` (default
        ``cuda``) in ``dtype``, with the reference's init scheme; with a
        ``dist`` whose mesh lies on that device type, distributed over it
        (the same values as without). On ``"meta"`` they are shapes only,
        and a ``dist`` (whose mesh may be any object with ``axis_names``
        and a ``shape`` mapping) only supplies ``param_specs``' rules."""
        dev = resolve_device(device)
        decl = tf.model_decl(cfg)
        mesh = dist.mesh if dist is not None else None
        if dev.type == "meta":
            # shapes only, for analysis: nothing to place (``param_specs``
            # says where each would go)
            tree = abstract_tree(decl, dtype)
            mesh = None
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            tree = init_tree(decl, gen, dev, dtype)
        if mesh is not None:
            if mesh.device_type != dev.type:
                raise ValueError(f"the mesh lies on {mesh.device_type}; "
                                 f"asked for {dev}")
            tree = _distribute(tree, spec_tree(decl, dist.rules, mesh), mesh)
        super().__init__(tree)
        self.cfg = cfg
        self.decl = decl
        self.dist = dist if dist is not None and dist.mesh is not None \
            else None
        self.is_encdec = cfg.encoder is not None
        # a cache's position tensor -> its count on the host (``advance``)
        self._filled = WeakIdKeyDictionary()

    # -- params ---------------------------------------------------------------
    def abstract_params(self, dtype=torch.float32):
        """The parameters' shapes as ``meta`` tensors (no storage)."""
        return abstract_tree(self.decl, dtype)

    def param_specs(self):
        """Each parameter's spec by the rules alone (no mesh)."""
        rules = self.dist.rules if self.dist else ShardingRules(
            embed=None, heads=None, kv_heads=None, ff=None, vocab=None,
            experts=None, lru=None, batch=None)
        return spec_tree(self.decl, rules)

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
        ctx = tf.Ctx(cfg=cfg, mode="train", dist=self.dist,
                     positions=torch.arange(T, device=tokens.device))
        with self.sharded_ops():
            x = tf.embed_tokens(params, inputs, cfg, dt, self._rules())
            if self.is_encdec:
                enc_out = encdec_mod.encode(params, self._frames(batch), cfg,
                                            ctx)
                ek, ev = encdec_mod.cross_kv(params, enc_out)
                x = encdec_mod.decode_blocks(params, x, cfg, ctx, ek, ev)
                loss = _xent(tf.logits_fn(params, x, cfg), labels)
            else:
                x, aux = tf.forward(params, x, cfg, ctx)
                loss = (_xent(tf.logits_fn(params, x, cfg), labels)
                        + cfg.aux_loss_weight * aux)
            return loss.full_tensor() if isinstance(loss, DTensor) else loss

    def sharded_ops(self):
        """The context the sharded loss and its backward run in
        (``distributed.sharding.sharded_ops``); a no-op without a mesh."""
        return contextlib.nullcontext() if self.dist is None \
            else sharded_ops()

    def _rules(self):
        return self.dist.rules if self.dist is not None else None

    # -- serving ----------------------------------------------------------------
    @property
    def capturable_decode(self) -> bool:
        """Whether a decode step can be captured as a CUDA graph and
        replayed: off a mesh, a decoder whose every block is
        full/global/window/local attention with a swiglu/gelu/moe MLP, no
        block of it synchronising with the host (a MoE block where
        ``moe.syncs``)."""
        if self.dist is not None or self.is_encdec:
            return False
        kinds = [b.split(":") for blocks, _ in self.cfg.segments
                 for b in blocks]
        syncs = any(m == "moe" for _, m in kinds) and moe_mod.syncs(self.cfg)
        return not syncs and all(a in tf.ATTN_KINDS and m in tf.MLP_KINDS
                                 for a, m in kinds)

    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16) -> dict:
        """Zeros (``transformer.init_cache``, ``encdec.encdec_cache``) on
        the model's device, the position 0; with a ``dist``, each tensor
        but the position a DTensor placed by ``launch.dryrun.cache_specs``
        (its shards made on each rank)."""
        make = encdec_mod.encdec_cache if self.is_encdec else tf.init_cache
        if self.dist is None:
            return make(self.cfg, batch, seq_len, dtype, device=self.device)
        from ..launch.dryrun import cache_specs   # it imports this module
        shapes = make(self.cfg, batch, seq_len, dtype, device="meta")
        shapes.pop("pos")
        mesh = self.dist.mesh

        def place(tree, spec):
            if isinstance(tree, dict):
                return {k: place(tree[k], spec[k]) for k in tree}
            if isinstance(tree, list):
                return [place(t, sp) for t, sp in zip(tree, spec)]
            return sharded_zeros(tree.shape, dtype=tree.dtype,
                                 device_mesh=mesh,
                                 placements=placements(spec, mesh,
                                                       tree.shape))

        return {"pos": torch.zeros((), dtype=torch.int64, device=self.device),
                **place(shapes, cache_specs(shapes, self.cfg, self.dist))}

    def capacity(self, cache: dict):
        """Positions ``cache`` can hold; None where it never fills."""
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
        cap = self.capacity(cache)
        if cap is not None and T > cap:
            raise ValueError(f"prompt of {T} tokens exceeds the cache "
                             f"({cap} positions)")
        ctx = tf.Ctx(cfg=self.cfg, mode="prefill", dist=self.dist,
                     positions=torch.arange(T, device=tokens.device))
        with self.sharded_ops():
            x = tf.embed_tokens(self, tokens, self.cfg, self._dtype(),
                                self._rules())
            if self.is_encdec:
                enc_out = encdec_mod.encode(self, self._frames(batch),
                                            self.cfg, ctx)
                ek, ev = encdec_mod.cross_kv(self, enc_out)
                for name, new in (("enc_k", ek), ("enc_v", ev)):
                    if cache[name].shape == new.shape:
                        put(cache, name, new)
                    else:
                        cache[name] = self._placed(
                            name, new.to(cache[name].dtype))
                x = encdec_mod.decode_blocks(self, x, self.cfg, ctx, ek, ev,
                                             cache=cache["self_kv"])
            else:
                x, _ = tf.forward(self, x, self.cfg, ctx, cache=cache)
            cache["pos"].fill_(T)
            self._filled[cache["pos"]] = T
            return tf.logits_fn(self, x[:, -1], self.cfg), cache

    def _placed(self, name: str, t):
        """A DTensor cache entry ``t`` placed by ``cache_specs``; a plain
        tensor as it is."""
        if not isinstance(t, DTensor):
            return t
        from ..launch.dryrun import cache_specs
        mesh = t.device_mesh
        spec = cache_specs({name: t}, self.cfg, self.dist)[name]
        return t.redistribute(mesh, placements(spec, mesh, t.shape))

    def advance(self, cache: dict, steps: int) -> None:
        """Count ``steps`` decode steps of ``cache`` on the host before they
        run (``decode_step`` counts its own, a caller replaying a captured
        ``decode_body`` its replays); raises where the full/global caches
        cannot hold them. The position on the device is left as it is."""
        filled = self._filled.get(cache["pos"], 0) + steps
        cap = self.capacity(cache)
        if cap is not None and filled > cap:
            raise ValueError(f"cache full: {filled} positions of {cap}")
        self._filled[cache["pos"]] = filled

    def decode_step(self, cache: dict, tokens):
        """tokens: [B, 1] at the cache's position -> (logits [B, V],
        cache), the cache extended in place and its position advanced.
        Raises once the full/global caches are full (``advance``)."""
        self.advance(cache, 1)
        return self.decode_body(cache, tokens), cache

    def decode_body(self, cache: dict, tokens) -> torch.Tensor:
        """The device's part of ``decode_step``, which leaves the host's count
        to the caller: the logits [B, V] of tokens [B, 1], the cache and
        its position advanced in place, the same ops at every position (so
        that ``serve.ServeEngine`` can replay one captured step)."""
        pos = cache["pos"]
        ctx = tf.Ctx(cfg=self.cfg, mode="decode", dist=self.dist,
                     positions=pos.view(1), pos=pos)
        with self.sharded_ops():
            x = tf.embed_tokens(self, tokens, self.cfg, self._dtype(),
                                self._rules())
            if self.is_encdec:
                x = encdec_mod.decode_blocks(self, x, self.cfg, ctx,
                                             cache["enc_k"], cache["enc_v"],
                                             cache=cache["self_kv"])
            else:
                x, _ = tf.forward(self, x, self.cfg, ctx, cache=cache)
            logits = tf.logits_fn(self, x[:, 0], self.cfg)
        pos.add_(1)
        return logits


def build(cfg: ModelConfig, device=None, dtype=None, seed: int = 0,
          dist=None) -> Model:
    """A ``Model`` on ``device`` (default ``cuda``; raises where CUDA is
    absent) with parameters in ``dtype`` (default float32), distributed
    over ``dist.mesh`` when a ``dist`` is given."""
    return Model(cfg, device=device, dtype=dtype or torch.float32, seed=seed,
                 dist=dist)
