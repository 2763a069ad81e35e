"""The column-list dequant kernel's share of its roofline: the bytes the
window's scans had to dequantize (every BF16 column of every row group the
zone maps kept, codes read once and f32 written once) at 3.35 TB/s, over
the device time of the kernel's launches."""

from perfbench.counts.peaks import HBM_BYTES_PER_S
from perfbench.counts.reads import dequant_bytes


def read(ctx):
    rec = ctx.records
    if "evaluated_rows" not in rec:
        return None
    cols = rec["quantized"]
    need = sum(dequant_bytes(cols, sum(rec["evaluated_rows"][name]))
               for name, _ in rec["scans"])
    t = ctx.kernel_seconds(lambda n: "dequant" in n)
    if not need or not t:
        return None
    return 100.0 * need / HBM_BYTES_PER_S / t
