"""The grouped expert path's share of its roofline: over the traced
window's grouped ``moe.experts`` device spans (arg ``path`` "grouped"),
the sum of each span's least time (``perfbench/counts/grouped.py``: its
6 x d x ff FLOPs a pair at the bf16 peak, or the weights of the experts
it touches and its pairs' rows in and out at 3.35 TB/s, whichever is
longer) over the sum of their ``device_s``."""

from perfbench.counts.grouped import grouped_least_s


def read(ctx):
    cfg = ctx.records.get("cfg")
    spans = [s for s in ctx.spans if s.name == "moe.experts"
             and s.args.get("path") == "grouped"]
    device = [s.args.get("device_s") for s in spans]
    if not cfg or not spans or None in device or not sum(device):
        return None
    least = sum(grouped_least_s(cfg, s.args["tokens"], s.args["pairs"],
                                s.args["experts"]) for s in spans)
    return 100.0 * least / sum(device)
