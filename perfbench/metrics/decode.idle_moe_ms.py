"""The device's idle time a decode step while the host runs the MoE block:
the complement of the union of the trace's device intervals, inside
``serve.decode`` spans, during which the host was inside a ``layer.moe``
span (route, dispatch, experts, combine), ms."""

from perfbench.lib import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, "layer.moe")
