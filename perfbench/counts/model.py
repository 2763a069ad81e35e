"""Operations and bytes of the MoE decoder's work, from its shapes (the
configuration file's Hugging Face keys). Frozen here from
``chip_smoke.py``'s ``_train_flops``, ``_serve_bounds``, ``_flash_work``
and ``_live_pairs``, with two changes of convention: training counts
model FLOPs (6 x active parameters x tokens and the causal attention's
forward and backward; the recompute is not counted), and a decode step
reads the experts its routes touch (the share expected of ``B * k``
uniform choices a layer) and the filled part of the cache.
"""

from __future__ import annotations


def live_pairs(S: int) -> int:
    """Live (query, key) pairs of a causal call over S positions."""
    return S * (S + 1) // 2


def params(cfg: dict) -> dict:
    """Parameter counts: ``embed``, ``head``, ``routed`` (all routed
    experts of all layers), ``other`` (attention, dense MLP, shared
    experts, routers, norms), ``active`` (a token's: other, its share of
    the routed experts, and the head)."""
    d, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    k, E = cfg["first_k_dense_replace"], cfg["n_routed_experts"]
    f, sf = cfg["moe_intermediate_size"], \
        cfg["moe_intermediate_size"] * cfg["n_shared_experts"]
    attn = d * (H + 2 * Hkv) * D + H * D * d + 2 * d
    dense = 3 * d * cfg["intermediate_size"]
    moe_other = d * E + 3 * d * sf
    routed = L - k and (L - k) * E * 3 * d * f
    other = L * attn + k * dense + (L - k) * moe_other + d
    share = cfg["num_experts_per_tok"] / E
    return {"embed": V * d, "head": d * V, "routed": routed, "other": other,
            "active": other + routed * share + d * V}


def train_flops(cfg: dict, B: int, S: int) -> float:
    """Model FLOPs of one training step on B x S tokens."""
    p = params(cfg)
    attn_fwd = 4 * cfg["head_dim"] * cfg["num_attention_heads"] \
        * B * live_pairs(S)
    return 6 * p["active"] * B * S + 3 * attn_fwd * cfg["num_hidden_layers"]


def flash_flops(cfg: dict, B: int, S: int) -> float:
    """Products of one causal flash-attention launch over B x S tokens:
    QK^T and PV over the live pairs."""
    return 4 * cfg["head_dim"] * cfg["num_attention_heads"] * B * live_pairs(S)


def decode_step(cfg: dict, B: int, pos: int, weight_bytes: int = 2,
                cache_bytes: int = 4) -> tuple:
    """(FLOPs, bytes) of one decode step of B tokens at position ``pos``:
    the products of a token's active weights and of its attention over
    pos + 1 cached positions; the weights read once (the routed experts
    that B x k uniform choices a layer touch, in expectation) and the
    filled cache read once."""
    p = params(cfg)
    L, E, k = cfg["num_hidden_layers"], cfg["n_routed_experts"], \
        cfg["num_experts_per_tok"]
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    n = pos + 1
    flops = 2 * p["active"] * B + 4 * D * H * n * B * L
    touched = 1.0 - (1.0 - k / E) ** B
    weights = (p["other"] + p["head"] + p["routed"] * touched) * weight_bytes
    cache = 2 * B * n * Hkv * D * L * cache_bytes
    return flops, weights + B * cfg["hidden_size"] * weight_bytes + cache
