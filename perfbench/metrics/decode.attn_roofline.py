"""Decode attention's share of its roofline: the least time of the decode
steps' attention over the device time of the decode-attention kernels (the
program's ``decode_attn_*`` launches) that start and end inside
``serve.decode`` spans. A call's prompt of ``prompt_len`` tokens (the
window's records) leaves step i at position P + i, which must read the K
and V rows of its valid slots, min(P + i + 1, S) of them (S the window
where the configuration has one), in the cache's dtype, for each of the
span's ``batch`` rows and each kv head, and its query and output in the
model's dtype, in every layer, at 3.35 TB/s. Slots past the position are
not counted, as the step need not read them. Nothing where no such kernel
ran inside a decode span (a program without the kernel)."""

import numpy as np

from perfbench.counts.grouped import BYTES
from perfbench.counts.peaks import HBM_BYTES_PER_S
from perfbench.lib import spans as _spans


def _attn(name: str) -> bool:
    return "decode_attn_" in name


def step_bytes(cfg: dict, batch: int, slots: int) -> int:
    """Bytes one decode step's attention must move in one layer at
    ``slots`` valid slots."""
    D = cfg["head_dim"]
    kv = 2 * slots * cfg["num_key_value_heads"] * D \
        * BYTES[cfg.get("cache_dtype", "float32")]
    q_out = 2 * cfg["num_attention_heads"] * D * BYTES[cfg["compute_dtype"]]
    return batch * (kv + q_out)


def read(ctx):
    cfg, P = ctx.records.get("cfg"), ctx.records.get("prompt_len")
    decode = _spans.span_intervals(ctx, "serve.decode")
    ops = [(s, d) for n, s, d in ctx.kernels if _attn(n)]
    if not cfg or P is None or decode is None or not ops:
        return None
    s, d = np.array(ops, dtype=np.float64).T
    inside = np.zeros(len(s), dtype=bool)
    for a, b in zip(*decode):
        inside |= (s >= a) & (s + d <= b)
    device_s = float(d[inside].sum()) / 1e6
    if not device_s:
        return None
    window = cfg.get("sliding_window") or None
    nbytes = 0
    for sp in ctx.spans:
        if sp.name == "serve.decode":
            B = int(sp.args["batch"])
            for i in range(int(sp.args["steps"])):
                slots = P + i + 1
                nbytes += step_bytes(cfg, B, min(slots, window or slots))
    least = nbytes * cfg["num_hidden_layers"] / HBM_BYTES_PER_S
    return 100.0 * least / device_s
