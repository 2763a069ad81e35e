"""AdamW's share of its roofline: the least bytes of a step's update at
3.35 TB/s over the device time of the program's ``train.optimizer`` spans
(``adamw_update``) a step. Least bytes: 32 a parameter, the f32 parameter
and both moments read and written, the f32 gradient read twice (once for
the global norm that clips it)."""

from perfbench.counts.model import params
from perfbench.counts.peaks import HBM_BYTES_PER_S
from perfbench.lib import spans

BYTES_PER_PARAM = 32


def read(ctx):
    ms = spans.device_ms_per_step(ctx, "train.optimizer")
    if not ms:
        return None
    p = params(ctx.records["cfg"])
    n = p["embed"] + p["head"] + p["routed"] + p["other"]
    return 100.0 * BYTES_PER_PARAM * n / HBM_BYTES_PER_S / (ms / 1e3)
