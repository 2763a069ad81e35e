"""Device ops a decode step: the trace's device ops (kernels, copies,
fills) that start and end inside a ``serve.decode`` span (the program's
decode loop through its closing synchronise, placed on the profiler's
timeline), over the spans' decode steps."""

from perfbench.lib import spans


def read(ctx):
    decode = spans.span_intervals(ctx, "serve.decode")
    ops = spans.device_intervals(ctx)
    steps = spans.decode_steps(ctx)
    if decode is None or ops is None or not steps:
        return None
    return spans.ops_inside(ops, decode) / steps
