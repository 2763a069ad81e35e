"""Mixture-of-Experts block, ported from ``repro.models.moe`` (its local,
single-device path): token-choice top-k routing with capacity, expert
products as batched matmuls, and the reference's chunked weight layout.

Routed expert weights are stored as ``E * tp`` chunks: chunk ``e * tp + j``
holds expert e's j-th slice of d_ff, with ``tp = M / gcd(E, M)`` for the
reference's production model axis ``M = 16`` (``moe_chunking``). The layout
is kept so that parameters, checkpoints and ``convert.load_jax_params``
carry the reference's keys and shapes. The reference's local path copies
the chunks back into dense ``[E, d, ff]`` weights every call (``unchunk``);
here the products run on views of the chunks and the ``tp`` partial
down-projections are summed, as the reference's ``shard_map`` path does
(exact up to the order of the sum).

The expert products are plain batched matmuls, as in the reference, which
computes them outside any kernel too. The sharded path (``shard_map`` over a
mesh) is the distributed item of ROADMAP.md and raises here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .base import P

PRODUCTION_M = 16  # model-axis size of the reference's production mesh


def moe_chunking(E: int, M: int = PRODUCTION_M) -> tuple[int, int]:
    """(tp, n_chunks): tp d_ff slices per expert, E * tp chunks in all."""
    tp = M // math.gcd(E, M)
    return tp, E * tp


def moe_decl(cfg) -> dict:
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_ff or cfg.d_ff
    tp, n_chunks = moe_chunking(E)
    if ff % tp:
        raise ValueError(f"expert d_ff {ff} is not a multiple of tp={tp}")
    ff_tp = ff // tp
    decl = {
        "router": P((d, E), ("embed", None)),
        "wg": P((n_chunks, d, ff_tp), ("experts", "embed", None)),
        "wu": P((n_chunks, d, ff_tp), ("experts", "embed", None)),
        "wd": P((n_chunks, ff_tp, d), ("experts", None, "embed")),
    }
    if cfg.n_shared:
        sff = (cfg.moe_ff or cfg.d_ff) * cfg.n_shared
        decl["shared"] = {
            "w_gate": P((d, sff), ("embed", "ff")),
            "w_up": P((d, sff), ("embed", "ff")),
            "w_down": P((sff, d), ("ff", "embed")),
        }
    return decl


def unchunk(w, E: int, ff_axis: int):
    """[n_chunks, a, b] chunk layout -> dense [E, d, ff] (``ff_axis=2``) or
    [E, ff, d] (``ff_axis=1``); a copy where tp > 1. The model does not
    call it (see the module's docstring); it states the layout."""
    n_chunks, a, b = w.shape
    tp = n_chunks // E
    if tp == 1:
        return w
    w4 = w.reshape(E, tp, a, b)
    if ff_axis == 2:
        return w4.permute(0, 2, 1, 3).reshape(E, a, tp * b)
    return w4.reshape(E, tp * a, b)


def _route(xt, router, top_k: int):
    """xt: [T, d] -> (weights [T, k] in xt's dtype, expert ids [T, k], the
    load-balancing aux loss, a 0-d f32 tensor). Gates are an f32 softmax;
    the top k are renormalised to sum to 1."""
    logits = xt.float() @ router.float()
    gates = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(gates, top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    E = router.shape[-1]
    me = gates.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=xt.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=xt.device)) \
        / idx.numel()
    aux = E * torch.sum(me * ce)
    return w.to(xt.dtype), idx, aux


def _dispatch(xt, idx, E: int, C: int):
    """Scatter tokens into an expert-major buffer [E, C, d] with capacity C.
    A (token, choice) pair's place in its expert counts over the flat
    [T * k] order (token-major); pairs past C are dropped. Returns (buffer,
    slot [T * k] (E * C where dropped), keep [T * k])."""
    T, k = idx.shape
    flat_e = idx.reshape(-1)
    # expert-major [E, T * k]: the running count is a scan along the inner
    # dim (a scan along the outer dim of [T * k, E] runs E lanes serially)
    onehot = F.one_hot(flat_e, E).t()
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos_in_e = pos.gather(0, flat_e[None, :])[0]
    keep = pos_in_e < C
    slot = torch.where(keep, flat_e * C + pos_in_e,
                       torch.full_like(flat_e, E * C))
    # kept slots are distinct; every dropped pair lands in the spare slot
    # E * C, which is cut off (no host sync, unlike indexing by `keep`)
    tokens = torch.arange(T, device=xt.device).repeat_interleave(k)
    token_of_slot = torch.zeros(E * C + 1, dtype=torch.long,
                                device=xt.device).scatter_(0, slot, tokens)
    filled = torch.zeros(E * C + 1, dtype=torch.bool,
                         device=xt.device).scatter_(
        0, slot, torch.ones_like(keep))
    buf = torch.where(filled[:E * C, None], xt[token_of_slot[:E * C]],
                      torch.zeros((), dtype=xt.dtype, device=xt.device))
    return buf.reshape(E, C, xt.shape[1]), slot, keep


def _experts(buf, p, E: int, dtype):
    """The routed experts' SwiGLU on buf [E, C, d] -> [E, C, d], over the
    chunk layout: each of an expert's tp chunks computes its slice of d_ff
    and its partial down-projection, and the partials are summed."""
    _, C, d = buf.shape
    tp = p["wg"].shape[0] // E
    xb = buf if tp == 1 else \
        buf[:, None].expand(E, tp, C, d).reshape(E * tp, C, d)
    h = torch.bmm(xb, p["wg"].to(dtype))
    u = torch.bmm(xb, p["wu"].to(dtype))
    out = torch.bmm(F.silu(h) * u, p["wd"].to(dtype))     # [E * tp, C, d]
    return out if tp == 1 else out.view(E, tp, C, d).sum(dim=1)


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens."""
    return max(1, int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def moe_apply(p, x, cfg):
    """The MoE block over x [B, S, d] -> (y [B, S, d], aux loss)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)

    w, idx, aux = _route(xt, p["router"], k)
    buf, slot, keep = _dispatch(xt, idx, E, C)
    out = _experts(buf, p, E, x.dtype).reshape(E * C, d)

    # combine: each (token, choice) pair's output, weighted, summed over k
    gathered = torch.where(keep[:, None],
                           out[torch.clamp(slot, max=E * C - 1)],
                           torch.zeros((), dtype=x.dtype, device=x.device))
    y = (gathered.reshape(T, k, d) * w[..., None]).sum(dim=1)

    if cfg.n_shared:
        sp = p["shared"]
        g = xt @ sp["w_gate"].to(x.dtype)
        u = xt @ sp["w_up"].to(x.dtype)
        y = y + (F.silu(g) * u) @ sp["w_down"].to(x.dtype)
    return y.reshape(B, S, d), aux


def moe_block(p, x, cfg, dist=None):
    """The local path; a mesh (``dist``) asks for the sharded path, which is
    not ported."""
    if dist is not None:
        raise NotImplementedError(
            "the sharded MoE path (shard_map over a mesh) is not ported yet: "
            "the 'Distributed' item of ROADMAP.md")
    return moe_apply(p, x, cfg)
