"""Weights of a decoder with a dense lead and MoE layers, made from a seed
on the device: one normal draw a layer (and one for the embedding and the
head) in the dtype they are served in, cut into the layer's matrices.

Each layer has its own generator state (``layer_seed``), so the
reference can make any one layer again, alone, after the program's copy
is freed. The layout is the logical one (experts ``[E, d, ff]``); the
bridge to the program (``perfbench/lib/models.py``) moves it into the
program's parameters.

Scales: each matrix is normal with standard deviation ``1/sqrt(fan_in)``
(its true fan-in: ``d`` for q, k, v; ``H * D`` for the attention's
output), the matrices that write into the residual stream (attention
output, the MLPs' and experts' down projections) further by
``1/sqrt(2 * layers)``, the embedding at 1, the norms' scales ones.
"""

from __future__ import annotations

import math


def layer_seed(seed: int, layer: int) -> int:
    """A generator seed for ``layer`` (-1: the embedding and the head)."""
    return (seed * 0x9E3779B1 + layer + 2) % (2**63 - 1)


def _leaves(m: dict, layer: int) -> list:
    """(name, shape, std) of one layer's drawn matrices, in draw order;
    ``layer`` -1 is the embedding and the head."""
    d, V = m["d"], m["vocab"]
    if layer < 0:
        return [("embed", (V, d), 1.0), ("lm_head", (d, V), 1 / math.sqrt(d))]
    H, Hkv, D, L = m["heads"], m["kv_heads"], m["head_dim"], m["layers"]
    out_scale = 1 / math.sqrt(2 * L)
    leaves = [("wq", (d, H, D), 1 / math.sqrt(d)),
              ("wk", (d, Hkv, D), 1 / math.sqrt(d)),
              ("wv", (d, Hkv, D), 1 / math.sqrt(d)),
              ("wo", (H, D, d), out_scale / math.sqrt(H * D))]
    if layer < m["dense_layers"]:
        ff = m["ff"]
        leaves += [("w_gate", (d, ff), 1 / math.sqrt(d)),
                   ("w_up", (d, ff), 1 / math.sqrt(d)),
                   ("w_down", (ff, d), out_scale / math.sqrt(ff))]
    else:
        E, f, sf = m["experts"], m["expert_ff"], m["expert_ff"] * m["shared"]
        leaves += [("router", (d, E), 1 / math.sqrt(d)),
                   ("wg", (E, d, f), 1 / math.sqrt(d)),
                   ("wu", (E, d, f), 1 / math.sqrt(d)),
                   ("wd", (E, f, d), out_scale / math.sqrt(f))]
        if sf:
            leaves += [("s_gate", (d, sf), 1 / math.sqrt(d)),
                       ("s_up", (d, sf), 1 / math.sqrt(d)),
                       ("s_down", (sf, d), out_scale / math.sqrt(sf))]
    return leaves


def make(m: dict, seed: int, layer: int, device, dtype) -> dict:
    """One layer's weights (``layer`` -1: ``embed``, ``lm_head`` and
    ``final_norm``): views of one normal draw, scaled in place, and the
    norms' scales."""
    import torch
    leaves = _leaves(m, layer)
    gen = torch.Generator(device=device)
    gen.manual_seed(layer_seed(seed, layer))
    total = sum(math.prod(s) for _, s, _ in leaves)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, std in leaves:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    ones = {"final_norm": 1} if layer < 0 else {"ln_attn": 1, "ln_mlp": 1}
    for name in ones:
        out[name] = torch.ones(m["d"], device=device, dtype=dtype)
    return out


def sizes(cfg: dict) -> dict:
    """The generator's sizes from a configuration file (Hugging Face key
    names)."""
    return {"d": cfg["hidden_size"], "vocab": cfg["vocab_size"],
            "heads": cfg["num_attention_heads"],
            "kv_heads": cfg["num_key_value_heads"],
            "head_dim": cfg["head_dim"], "layers": cfg["num_hidden_layers"],
            "dense_layers": cfg["first_k_dense_replace"],
            "ff": cfg["intermediate_size"], "experts": cfg["n_routed_experts"],
            "expert_ff": cfg["moe_intermediate_size"],
            "shared": cfg["n_shared_experts"]}
