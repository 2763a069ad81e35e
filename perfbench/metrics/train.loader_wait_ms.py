"""Time the training step waited on ``BullionLoader``: the benchmark's
clock around ``next(loader)`` in the untraced window, ms per step
(median)."""

import statistics


def read(ctx):
    waits = ctx.plain.get("loader_wait_s")
    if not waits:
        return None
    return statistics.median(waits) * 1e3
