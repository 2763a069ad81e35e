"""Roofline terms of a dry-run cell, ported from ``repro.launch.roofline``.

  compute term    = FLOPs (per device) / peak FLOP/s
  memory term     = bytes (per device) / HBM bandwidth
  collective term = collective bytes moved per device / NVLink bandwidth

The counts are ``launch.hlo_cost``'s, taken from the ops that run on one
rank's shards. The constants are the H100 SXM data sheet's
(``launch.mesh``): NVLink's 450 GB/s each way stands where the reference
reads one ICI link. The formula stays the reference's single link: a
16-wide 'model' axis spans two 8-card hosts, whose link between hosts is
slower than NVLink, and the term does not model it.
"""

from __future__ import annotations

from collections import defaultdict

from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


def parse_collectives(counted: dict) -> dict:
    """Bytes moved per device by kind, counts and total, from a
    ``hlo_cost.analyze`` result (its ring-factored collective bytes)."""
    by_kind: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for kind, moved in counted["collective_by_kind"].items():
        by_kind[kind] += moved
    for kind, n in counted["collective_counts"].items():
        counts[kind] += int(n)
    return {"bytes_by_kind": dict(by_kind), "counts": dict(counts),
            "total_bytes": sum(by_kind.values())}


def model_flops(cfg, shape, n_params_total: int, n_params_active: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * tokens
    tokens = shape.global_batch  # one step
    return 2.0 * n_params_active * tokens


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    ct = flops_per_dev / PEAK_FLOPS_BF16
    mt = bytes_per_dev / HBM_BW
    xt = coll_bytes_per_dev / NVLINK_BW
    dom = max((ct, "compute"), (mt, "memory"), (xt, "collective"))[1]
    return {"compute_s": ct, "memory_s": mt, "collective_s": xt,
            "dominant": dom,
            "bound_s": max(ct, mt, xt),
            "roofline_frac": ct / max(ct, mt, xt) if max(ct, mt, xt) > 0 else 0.0}


def active_params(cfg, n_params_total: int) -> int:
    """Active params per token for MoE configs (routed experts scaled by k/E)."""
    if cfg.n_experts == 0:
        return n_params_total
    ff = cfg.moe_ff or cfg.d_ff
    routed_per_layer = 3 * cfg.d_model * ff * cfg.n_experts
    n_moe_layers = sum(rep * sum(1 for b in blocks if b.endswith(":moe"))
                       for blocks, rep in cfg.segments)
    routed_total = routed_per_layer * n_moe_layers
    active_routed = routed_total * cfg.top_k / cfg.n_experts
    return int(n_params_total - routed_total + active_routed)
