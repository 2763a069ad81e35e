"""The range-filter kernel's share of its roofline: for every scan whose
predicate is a conjunction of ranges over float columns (the kernel's
route), the ``[C, N]`` f32 block of every row group the zone maps kept,
read once, and its mask written once, at 3.35 TB/s, over the device time
of the kernel's launches."""

from perfbench.counts.peaks import HBM_BYTES_PER_S
from perfbench.counts.reads import filter_bytes


def read(ctx):
    rec = ctx.records
    if "evaluated_rows" not in rec:
        return None
    need = 0
    for name, _ in rec["scans"]:
        terms = rec["filter_terms"][name]
        if terms:
            need += filter_bytes(terms, sum(rec["evaluated_rows"][name]))
    t = ctx.kernel_seconds(lambda n: "range_mask" in n)
    if not need or not t:
        return None
    return 100.0 * need / HBM_BYTES_PER_S / t
