"""The prefill's model FLOPs (``perfbench/counts/grouped.py``
``prefill_flops``: 2 x the active parameters x B x P, the head at the last
positions only, and causal attention over the live pairs) over the
untraced window's mean ``prefill_s`` (``ServeEngine.generate``'s host
clock around its prefill, closed by a synchronise), at the compute
dtype's peak."""

from perfbench.counts.grouped import prefill_flops
from perfbench.counts.peaks import FLOPS


def read(ctx):
    rec = ctx.plain
    calls = rec.get("calls")
    if not calls:
        return None
    cfg = rec["cfg"]
    t = sum(c["prefill_s"] for c in calls) / len(calls)
    flops = prefill_flops(cfg, rec["batch"], rec["prompt_len"])
    return 100.0 * flops / FLOPS[cfg["compute_dtype"]] / t
