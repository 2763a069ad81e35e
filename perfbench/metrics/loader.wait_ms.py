"""The training step blocked on ``BullionLoader``'s prefetch thread, from
inside the program: the median of its ``loader.wait`` spans (the consumer
in ``queue.get``) in the traced window, ms."""

import statistics


def read(ctx):
    waits = [s.dur for s in ctx.spans if s.name == "loader.wait"]
    if not waits:
        return None
    return statistics.median(waits) * 1e3
