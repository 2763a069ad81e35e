"""The whole decode step's share of its roofline: the least time of a step,
the larger of its FLOPs at the bf16 peak and its bytes (the weights of the
experts its routes touch, in expectation, the rest of the weights, and the
filled f32 cache, each read once) at 3.35 TB/s, averaged over the steps of
a call, over ``decode.step_ms`` (the untraced window's steps)."""

from perfbench.counts.model import decode_step
from perfbench.counts.peaks import FLOPS, HBM_BYTES_PER_S


def read(ctx):
    rec = ctx.plain
    calls = rec.get("calls")
    if not calls:
        return None
    cfg, B, P, n = rec["cfg"], rec["batch"], rec["prompt_len"], rec["new_tokens"]
    bound = 0.0
    for t in range(n):
        flops, nbytes = decode_step(cfg, B, P + t)
        bound += max(flops / FLOPS[cfg["compute_dtype"]],
                     nbytes / HBM_BYTES_PER_S)
    step = sum(c["decode_s"] for c in calls) / (len(calls) * n)
    return 100.0 * (bound / n) / step
