"""The grouped expert kernels' share of their roofline in decode: the least
time of the decode steps' grouped experts over the device time of the
grouped GEMM kernels (torch's CUTLASS ``GroupProblemShape`` kernels of
``_grouped_mm``) that start and end inside ``serve.decode`` spans. A step
routes each of its B tokens (the span's ``batch``) to k experts in every
MoE layer, so a layer's least time is ``perfbench/counts/grouped.py``'s
at B tokens and B x k pairs; the spans' steps times the configuration's
MoE layers give the window's. Replayed and eager steps read alike;
nothing where no such kernel ran inside a decode span (the capacity
path)."""

import numpy as np

from perfbench.counts.grouped import grouped_least_s
from perfbench.lib import spans as _spans


def _grouped(name: str) -> bool:
    return "cutlass" in name and "GroupProblemShape" in name


def read(ctx):
    cfg = ctx.records.get("cfg")
    decode = _spans.span_intervals(ctx, "serve.decode")
    ops = [(s, d) for n, s, d in ctx.kernels if _grouped(n)]
    if not cfg or decode is None or not ops:
        return None
    s, d = np.array(ops, dtype=np.float64).T
    inside = np.zeros(len(s), dtype=bool)
    for a, b in zip(*decode):
        inside |= (s >= a) & (s + d <= b)
    device_s = float(d[inside].sum()) / 1e6
    if not device_s:
        return None
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    k, E = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    least = 0.0
    for sp in ctx.spans:
        if sp.name == "serve.decode":
            B = int(sp.args["batch"])
            least += int(sp.args["steps"]) * layers \
                * grouped_least_s(cfg, B, B * k, E)
    return 100.0 * least / device_s
