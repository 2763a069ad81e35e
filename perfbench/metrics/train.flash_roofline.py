"""The flash-attention kernel's share of its roofline in training: the
products of the live causal pairs of every launch of the kernel in the
traced window, counted from the trace's list of device ops by kind (a
forward launch, ``flash_fwd*``: QK^T and PV; a backward one,
``flash_bwd*``: the five products of the pairs), at the float32 peak,
over the device time of those launches. Each launch covers one call over
the step's batch, heads and sequence. A launch of a kind not known here
leaves the metric unread."""

from perfbench.counts.model import flash_flops
from perfbench.counts.peaks import FLOPS

# products of a launch's live pairs, in units of a forward launch's
KINDS = {"flash_fwd": 1.0, "flash_bwd": 2.5}


def read(ctx):
    rec = ctx.records
    launches = [(n, d) for n, _, d in ctx.kernels if "flash" in n]
    if not rec.get("step_s") or not launches:
        return None
    units = 0.0
    for name, _ in launches:
        kind = [w for k, w in KINDS.items() if k in name]
        if len(kind) != 1:
            return None
        units += kind[0]
    cfg = rec["cfg"]
    need = units * flash_flops(cfg, rec["batch"], rec["seq"])
    t = sum(d for _, d in launches) / 1e6
    return 100.0 * need / FLOPS[cfg["compute_dtype"]] / t
