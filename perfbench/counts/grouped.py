"""Operations and bytes of the MoE decoder's grouped expert path and of its
prefill, from the configuration file's Hugging Face keys and the program's
span args.

A grouped ``moe.experts`` span (args ``tokens``, ``pairs``, ``experts``)
computes each routed pair's SwiGLU alone: 6 x d x ff FLOPs a pair (three
products); it reads the weights of the experts its pairs touch, each once
(of the span's ``experts``, the share expected of ``tokens`` tokens'
uniform top-k choices: all of them in a prefill), and each pair's row in
and its output row out.
"""

from __future__ import annotations

from perfbench.counts.model import live_pairs, params
from perfbench.counts.peaks import FLOPS, HBM_BYTES_PER_S

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def grouped_experts(cfg: dict, tokens: int, pairs: int,
                    experts: int) -> tuple:
    """(FLOPs, bytes) of one grouped ``moe.experts`` span."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    k, E = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    touched = experts * (1.0 - (1.0 - k / E) ** tokens)
    weights = touched * 3 * d * f * BYTES[cfg["torch_dtype"]]
    rows = 2 * pairs * d * BYTES[cfg["compute_dtype"]]
    return 6 * d * f * pairs, weights + rows


def grouped_least_s(cfg: dict, tokens: int, pairs: int,
                    experts: int) -> float:
    """The least time of one grouped span: the larger of its FLOPs at the
    compute dtype's peak and its bytes at 3.35 TB/s."""
    flops, nbytes = grouped_experts(cfg, tokens, pairs, experts)
    return max(flops / FLOPS[cfg["compute_dtype"]], nbytes / HBM_BYTES_PER_S)


def prefill_flops(cfg: dict, B: int, P: int) -> float:
    """Model FLOPs of a prefill of B prompts of P tokens: 2 x the active
    parameters but the head x B x P, the head at the B last positions only
    (the prefill's logits), and causal attention over the live pairs."""
    p = params(cfg)
    attn = 4 * cfg["head_dim"] * cfg["num_attention_heads"] * B \
        * live_pairs(P) * cfg["num_hidden_layers"]
    return 2 * (p["active"] - p["head"]) * B * P + 2 * p["head"] * B + attn
