"""RWKV-6 "Finch" block, ported from ``repro.models.rwkv6``: data-dependent
token shift (ddlerp), data-dependent per-channel decay, the WKV linear
recurrence and a squared-ReLU channel mix. Attention-free; its decode state
is O(1) in sequence length, ``{"S": [B, H, D, D], "tm_prev": [B, d],
"cm_prev": [B, d]}``, f32 whatever the compute dtype, updated in place.

WKV has two forms, as in the reference: ``wkv_scan``, a loop over time in
f32 (one step a token), and ``wkv_chunked``, chunk-parallel products over
chunks of 64 with the reference's ``-60`` clamps. Both stay plain PyTorch:
the reference has no kernel for them.

On a mesh (DTensor parameters) r, k, v and w are held at ``("batch", None,
"heads", None)``, the time axis whole, as the reference constrains them,
and the recurrence runs under ``local_map`` on each rank's batch rows and
heads: one DTensor dispatch a layer instead of one an op a token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import local_map

from ..distributed.placement import grad_placements, placements
from .base import P, constrain
from .cache import put
from .layers import _proj, flat, layernorm, layernorm_decl

LORA_R = 32
LORA_W = 64
MIX_KEYS = ("r", "k", "v", "g", "w")


def rwkv_decl(cfg) -> dict:
    d, H, dh, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    tm = {
        "mu_x": P((d,), (None,), init="zeros"),
        "w0": P((H, dh), ("heads", None), init="zeros"),
        "u": P((H, dh), ("heads", None)),
        "lora_w1": P((d, LORA_W), ("embed", None)),
        "lora_w2": P((LORA_W, d), (None, "embed")),
        "wo": P((H, dh, d), ("heads", None, "embed")),
        "ln_x": layernorm_decl(dh),
    }
    if cfg.fused_qkv:
        tm["wrkvg"] = P((d, 4, H, dh), ("embed", None, "heads", None))
    else:
        for key in ("wr", "wk", "wv", "wg"):
            tm[key] = P((d, H, dh), ("embed", "heads", None))
    for key in MIX_KEYS:
        tm[f"mu_{key}"] = P((d,), (None,), init="zeros")
        tm[f"A_{key}"] = P((d, LORA_R), ("embed", None))
        tm[f"B_{key}"] = P((LORA_R, d), (None, "embed"))
    cm = {
        "mu_k": P((d,), (None,), init="zeros"),
        "mu_r": P((d,), (None,), init="zeros"),
        "wk": P((d, ff), ("embed", "ff")),
        "wv": P((ff, d), ("ff", "embed")),
        "wr": P((d, d), ("embed", None)),
    }
    return {"ln1": layernorm_decl(d), "ln2": layernorm_decl(d), "tm": tm,
            "cm": cm}


def _shift(x, prev):
    """x [B, T, d]; prev [B, d] (the token before x) -> x shifted by one."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(p, key, x, xx, xin):
    lora = _proj(torch.tanh(_proj(xin, p[f"A_{key}"])), p[f"B_{key}"])
    return x + (xx - x) * (p[f"mu_{key}"].to(x.dtype) + lora)


def wkv_scan(r, k, v, w, u, state):
    """The WKV6 recurrence, one step a token, in f32.
    r, k, v, w: [B, T, H, D]; u: [H, D]; state: [B, H, D, D].
    Returns (y [B, T, H, D] in r's dtype, the final state)."""
    S = state.float()
    rt, kt, vt, wt = (t.float() for t in (r, k, v, w))
    uu = u[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        kv = kt[:, t, :, :, None] * vt[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", rt[:, t], S + uu * kv))
        S = wt[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S


def wkv_chunked(r, k, v, w, u, state, chunk: int = 64):
    """Chunk-parallel WKV6 (GLA-style): T / chunk sequential steps of
    products instead of T elementwise steps, f32 throughout; the
    reference's clamps of the cumulative log-decay at -60."""
    B, T, H, D = r.shape
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of the chunk {chunk}")
    n = T // chunk
    rc, kc, vc = (t.reshape(B, n, chunk, H, D).float() for t in (r, k, v))
    lw = torch.log(torch.clamp(w.reshape(B, n, chunk, H, D).float(),
                               min=1e-38))
    cum = torch.cumsum(lw, dim=2)                          # inclusive
    cum_excl = torch.clamp(cum - lw, min=-60.0)
    total = torch.clamp(cum[:, :, -1], min=-60.0)          # [B, n, H, D]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), -1)
    S = state.float()
    ys = []
    for c in range(n):
        r_, k_, v_ = rc[:, c], kc[:, c], vc[:, c]
        ce, tot, lw_ = cum_excl[:, c], total[:, c], lw[:, c]
        r_dec = r_ * torch.exp(ce)
        y_inter = torch.einsum("bchi,bhij->bchj", r_dec, S)
        k_dec = k_ * torch.exp(-ce - lw_)
        att = torch.einsum("bchi,bdhi->bhcd", r_dec, k_dec)
        att = torch.where(mask, att, 0.0)
        diag = torch.einsum("bchi,bchi,hi->bch", r_, k_, u)
        y_intra = torch.einsum("bhcd,bdhj->bchj", att, v_) \
            + diag[..., None] * v_
        k_tail = k_ * torch.exp(tot[:, None] - ce - lw_)
        S = torch.exp(tot)[..., None] * S \
            + torch.einsum("bchi,bchj->bhij", k_tail, v_)
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, dim=1).reshape(B, T, H, D)
    return y.to(r.dtype), S


def _sharded_wkv(wkv, r, k, v, w, u, state, rules):
    """``wkv`` under ``local_map`` on DTensors r, k, v, w [B, T, H, D] and
    u [H, D]; ``state`` [B, H, D, D] a cache's (a DTensor of a sharded
    cache, or a plain tensor, whole) or None (zeros). Returns (y, the
    final state), DTensors."""
    spec = ("batch", None, "heads", None)
    r, k, v, w = (constrain(t, rules, spec) for t in (r, k, v, w))
    mesh = r.device_mesh
    B, _, H, D = r.shape
    plc = placements(rules.spec_for(spec), mesh, r.shape)
    uplc = placements(rules.spec_for(("heads", None)), mesh, u.shape)
    splc = placements(rules.spec_for(("batch", "heads", None, None)), mesh,
                      (B, H, D, D))
    args = [r, k, v, w, u]
    in_plc = [plc] * 4 + [uplc]
    if state is not None:
        args.append(state.redistribute(mesh, splc) if isinstance(state, DTensor)
                    else distribute_tensor(state, mesh, splc))
        in_plc.append(splc)

    def local(rl, kl, vl, wl, ul, sl=None):
        if sl is None:
            sl = rl.new_zeros(rl.shape[:1] + rl.shape[2:] + rl.shape[-1:],
                              dtype=torch.float32)
        return wkv(rl, kl, vl, wl, ul, sl)

    y, s = local_map(local, out_placements=(plc, splc),
                     in_placements=tuple(in_plc),
                     in_grad_placements=tuple(grad_placements(i, plc)
                                              for i in in_plc),
                     device_mesh=mesh, redistribute_inputs=True)(*args)
    return y, s


def rwkv_block(p, x, cache=None, *, cfg, use_chunked: bool = False,
               dist=None):
    """The full RWKV-6 layer (time mix + channel mix): x [B, T, d] -> x.
    ``cache`` ({"S", "tm_prev", "cm_prev"} of this layer, f32) is read as
    the initial state and overwritten with the final one, in place; None in
    training. ``use_chunked`` takes ``wkv_chunked`` for T > 1 with
    T % 64 == 0, ``wkv_scan`` otherwise. DTensor parameters run the
    recurrence on local shards (``_sharded_wkv``) by ``dist``'s rules."""
    B, T, d = x.shape
    H, dh = cfg.n_heads, cfg.head_dim

    # ---- time mix ----
    xn = layernorm(p["ln1"], x)
    tm = p["tm"]
    prev = cache["tm_prev"].to(x.dtype) if cache is not None \
        else torch.zeros((B, d), dtype=x.dtype, device=x.device)
    xx = _shift(xn, prev)
    xin = xn + (xx - xn) * tm["mu_x"].to(x.dtype)
    xr, xk, xv, xg, xw = (_ddlerp(tm, key, xn, xx, xin) for key in MIX_KEYS)

    if "wrkvg" in tm:
        xs4 = torch.stack([xr, xk, xv, xg], dim=2)           # [B, T, 4, d]
        rkvg = torch.einsum("btfd,dfhk->btfhk", xs4, tm["wrkvg"].to(x.dtype))
        r, k, v, g = rkvg.unbind(dim=2)
    else:
        r, k, v, g = (_proj(xi, tm[key]) for xi, key in
                      ((xr, "wr"), (xk, "wk"), (xv, "wv"), (xg, "wg")))
    wlo = _proj(torch.tanh(_proj(xw, tm["lora_w1"])), tm["lora_w2"])
    wln = tm["w0"].float()[None, None] + wlo.reshape(B, T, H, dh).float()
    w = torch.exp(-torch.exp(wln)).to(x.dtype)                # (0, 1) decay

    u = tm["u"].float()
    wkv = wkv_chunked if use_chunked and T > 1 and T % 64 == 0 else wkv_scan
    if isinstance(r, DTensor):
        if dist is None:
            raise ValueError("sharded RWKV needs the sharding rules (dist)")
        y, state = _sharded_wkv(wkv, r, k, v, w, u,
                                cache["S"] if cache is not None else None,
                                dist.rules)
    else:
        state = cache["S"] if cache is not None else torch.zeros(
            (B, H, dh, dh), dtype=torch.float32, device=x.device)
        y, state = wkv(r, k, v, w, u, state)
    y = layernorm(tm["ln_x"], y) * F.silu(g)                 # per-head norm
    x = x + y.flatten(-2) @ flat(tm["wo"].to(x.dtype), 2)

    # ---- channel mix ----
    cm = p["cm"]
    xn2 = layernorm(p["ln2"], x)
    prev2 = cache["cm_prev"].to(x.dtype) if cache is not None \
        else torch.zeros((B, d), dtype=x.dtype, device=x.device)
    xx2 = _shift(xn2, prev2)
    xk2 = xn2 + (xx2 - xn2) * cm["mu_k"].to(x.dtype)
    xr2 = xn2 + (xx2 - xn2) * cm["mu_r"].to(x.dtype)
    kk = torch.square(torch.relu(_proj(xk2, cm["wk"])))
    rr = torch.sigmoid(_proj(xr2, cm["wr"]))
    x = x + rr * _proj(kk, cm["wv"])

    if cache is not None:
        for name, t in (("S", state), ("tm_prev", xn[:, -1]),
                        ("cm_prev", xn2[:, -1])):
            put(cache, name, t)
    return x


def rwkv_cache_decl(cfg, batch: int, device=None) -> dict:
    H, dh, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"S": torch.zeros((batch, H, dh, dh), **f32),
            "tm_prev": torch.zeros((batch, d), **f32),
            "cm_prev": torch.zeros((batch, d), **f32)}
