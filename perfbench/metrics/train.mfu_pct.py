"""The training step's share of the card's peak: the model FLOPs of every
step of the untraced window (6 x active parameters x tokens, plus the
causal attention's forward and backward; the recompute not counted) over
that window, against the peak of the configuration's precision (float32
with TF32 off: 67 TFLOP/s)."""

from perfbench.counts.model import train_flops
from perfbench.counts.peaks import FLOPS


def read(ctx):
    rec = ctx.plain
    steps = rec.get("step_s")
    if not steps or not ctx.plain_s:
        return None
    cfg = rec["cfg"]
    flops = len(steps) * train_flops(cfg, rec["batch"], rec["seq"])
    return 100.0 * flops / ctx.plain_s / FLOPS[cfg["compute_dtype"]]
