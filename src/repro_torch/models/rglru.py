"""RG-LRU recurrent block (Griffin / RecurrentGemma), ported from
``repro.models.rglru``: a gated linear recurrence with input-dependent
retention, a temporal conv and GeGLU-style gating. Decode carries O(1)
state, ``{"h": [B, lru], "conv": [B, K-1, lru]}``, f32 whatever the compute
dtype, updated in place.

Over a sequence the recurrence ``h_t = a_t h_{t-1} + b_t`` is the
reference's ``jax.lax.associative_scan`` with the same combine, run here as
a log-step (Hillis-Steele) scan: ``ceil(log2 T)`` doubling steps of whole-
tensor products, not a loop over time. Its sums are ordered differently
from XLA's, so it agrees with the reference to rounding. It stays plain
PyTorch: the reference has no kernel for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed.placement import grad_placements
from .base import P
from .cache import put
from .layers import _proj, rmsnorm, rmsnorm_decl

RG_C = 8.0  # Griffin's constant c


def rglru_decl(cfg) -> dict:
    d = cfg.d_model
    lru = cfg.lru_width or d
    H = cfg.n_heads  # block-diagonal gate heads
    bd = lru // H
    return {
        "norm": rmsnorm_decl(d),
        "w_gate_in": P((d, lru), ("embed", "lru")),
        "w_main_in": P((d, lru), ("embed", "lru")),
        "conv_w": P((cfg.conv_width, lru), (None, "lru")),
        "conv_b": P((lru,), ("lru",), init="zeros"),
        "lam": P((lru,), ("lru",), init="ones"),          # retention logits
        "wa": P((H, bd, bd), ("heads", None, None)),      # recurrence gate
        "ba": P((lru,), ("lru",), init="zeros"),
        "wx": P((H, bd, bd), ("heads", None, None)),      # input gate
        "bx": P((lru,), ("lru",), init="zeros"),
        "w_out": P((lru, d), ("lru", "embed")),
    }


def _block_diag(x, w, H: int):
    """x [B, T, lru] -> the block-diagonal linear map by heads,
    [B, T, H, bd] @ [H, bd, bd]. A DTensor x runs under ``local_map`` on
    its batch rows, w whole: DTensor's einsum may shard the heads over an
    axis that does not divide them and then fail to split them back (4
    heads over model = 3)."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        xp = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
        rep = (Replicate(),) * mesh.ndim
        return local_map(lambda xl, wl: _block_diag(xl, wl, H),
                         out_placements=[*xp], in_placements=(xp, rep),
                         in_grad_placements=(xp, grad_placements(rep, xp)),
                         device_mesh=mesh, redistribute_inputs=True)(x, w)
    B, T, lru = x.shape
    xh = x.reshape(B, T, H, lru // H)
    return torch.einsum("bthi,hij->bthj", xh, w.to(x.dtype)).reshape(B, T, lru)


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv of width K. x [B, T, lru]; state [B, K-1, lru]
    (the inputs before x; zeros when None). Returns (out, the last K-1
    inputs)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # [B, T+K-1, lru]
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * w[i].to(x.dtype) for i in range(K))
    new_state = xp[:, xp.shape[1] - (K - 1):] if K > 1 else pad
    return out + b.to(x.dtype), new_state


def linear_scan(a, b):
    """The inclusive scan of ``h_t = a_t h_{t-1} + b_t`` over axis 1 from
    h = 0: returns (prod_{s<=t} a_s, h_t), by log-step doubling with the
    reference's combine ``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)``."""
    T, d = a.shape[1], 1
    while d < T:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def rglru_block(p, x, cache=None, *, cfg):
    """x [B, T, d] -> x + the block's output. ``cache`` ({"h", "conv"} of
    this layer, f32) is read as the initial state and overwritten with the
    final one, in place; None in training."""
    H = cfg.n_heads
    xn = rmsnorm(p["norm"], x)
    gate = F.gelu(_proj(xn, p["w_gate_in"]), approximate="tanh")
    main = _proj(xn, p["w_main_in"])
    conv_state = cache["conv"] if cache is not None else None
    main, new_conv = _causal_conv(main, p["conv_w"], p["conv_b"], conv_state)

    r = torch.sigmoid(_block_diag(main, p["wa"], H) + p["ba"].to(x.dtype))
    i = torch.sigmoid(_block_diag(main, p["wx"], H) + p["bx"].to(x.dtype))
    log_a = -RG_C * F.softplus(p["lam"].float()) * r.float()   # <= 0
    a = torch.exp(log_a)
    gated_x = (i * main).float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated_x

    if cache is not None and x.shape[1] == 1:
        hs = (a[:, 0] * cache["h"] + b[:, 0])[:, None]
    else:
        a_s, hs = linear_scan(a, b)
        if cache is not None:   # prefill: fold in the initial state
            hs = hs + a_s * cache["h"][:, None, :]
    out = _proj(gate * hs.to(x.dtype), p["w_out"])
    if cache is not None:
        put(cache, "h", hs[:, -1])
        put(cache, "conv", new_conv)
    return x + out


def rglru_cache_decl(cfg, batch: int, device=None) -> dict:
    lru = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, lru), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, lru),
                                dtype=torch.float32, device=device)}
