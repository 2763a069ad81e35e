"""RWKV-6 "Finch" block, ported from ``repro.models.rwkv6``: data-dependent
token shift (ddlerp), data-dependent per-channel decay, the WKV linear
recurrence and a squared-ReLU channel mix. Attention-free; its decode state
is O(1) in sequence length, ``{"S": [B, H, D, D], "tm_prev": [B, d],
"cm_prev": [B, d]}``, f32 whatever the compute dtype, updated in place.

WKV has two forms, as in the reference: ``wkv_scan``, a loop over time in
f32 (one step a token), and ``wkv_chunked``, chunk-parallel products over
chunks of 64 with the reference's ``-60`` clamps. Both stay plain PyTorch:
the reference has no kernel for them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import P
from .layers import _proj, layernorm, layernorm_decl

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


def rwkv_block(p, x, cache=None, *, cfg, use_chunked: bool = False,
               dist=None):
    """The full RWKV-6 layer (time mix + channel mix): x [B, T, d] -> x.
    ``cache`` ({"S", "tm_prev", "cm_prev"} of this layer, f32) is read as
    the initial state and overwritten with the final one, in place; None in
    training. ``use_chunked`` takes ``wkv_chunked`` for T > 1 with
    T % 64 == 0, ``wkv_scan`` otherwise."""
    if dist is not None:
        raise NotImplementedError(
            "sharded RWKV (sharding constraints over a mesh) is not ported "
            "yet: the 'Distributed' item of ROADMAP.md")
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

    state = cache["S"] if cache is not None else torch.zeros(
        (B, H, dh, dh), dtype=torch.float32, device=x.device)
    u = tm["u"].float()
    if use_chunked and T > 1 and T % 64 == 0:
        y, state = wkv_chunked(r, k, v, w, u, state)
    else:
        y, state = wkv_scan(r, k, v, w, u, state)
    y = layernorm(tm["ln_x"], y) * F.silu(g)                 # per-head norm
    wo = tm["wo"]
    x = x + y.flatten(-2) @ wo.to(x.dtype).reshape(-1, wo.shape[-1])

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
        cache["S"].copy_(state)
        cache["tm_prev"].copy_(xn[:, -1])
        cache["cm_prev"].copy_(xn2[:, -1])
    return x


def rwkv_cache_decl(cfg, batch: int, device=None) -> dict:
    H, dh, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"S": torch.zeros((batch, H, dh, dh), **f32),
            "tm_prev": torch.zeros((batch, d), **f32),
            "cm_prev": torch.zeros((batch, d), **f32)}
