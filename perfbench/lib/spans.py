"""The program's spans as the per-layer readers read them: beside the
device's ops on one timeline, the profiler's microseconds, where
``obs.trace.profiler_us`` places a span's start; and the device time its
device spans carry (``args["device_s"]``)."""

from __future__ import annotations

import numpy as np


def span_intervals(ctx, name: str):
    """(starts, ends) in the profiler's us of the spans named ``name``; None
    where there are none, or where the program cannot place its spans on
    the profiler's timeline."""
    try:
        from repro_torch.obs.trace import profiler_us
    except ImportError:
        return None
    recs = [s for s in ctx.spans if s.name == name]
    if not recs:
        return None
    starts = np.array([profiler_us(s) for s in recs])
    return starts, starts + np.array([s.dur for s in recs]) * 1e6


def device_intervals(ctx):
    """(starts, ends) in us of every device op of the trace; None where it
    has none."""
    if not ctx.kernels:
        return None
    k = np.array([(s, d) for _, s, d in ctx.kernels], dtype=np.float64)
    return k[:, 0], k[:, 0] + k[:, 1]


def decode_steps(ctx) -> int:
    """Decode steps of the window: the ``serve.decode`` spans' ``steps``."""
    return sum(int(s.args.get("steps", 0)) for s in ctx.spans
               if s.name == "serve.decode")


def ops_inside(ops, spans) -> int:
    """Device ops whose whole interval lies inside one of the spans."""
    s, e = ops
    return sum(int(np.count_nonzero((s >= a) & (e <= b)))
               for a, b in zip(*spans))


def idle_inside(decode, ops, host) -> float:
    """Microseconds in which the host was inside a ``decode`` span and a
    ``host`` span while no device op ran: a sweep over every interval's
    ends, each set counted apart, so nested or overlapping intervals of
    one set count once."""
    sets = (decode, ops, host)
    pos = np.concatenate([np.concatenate(iv) for iv in sets])
    delta = np.zeros((len(pos), len(sets)), dtype=np.int64)
    at = 0
    for j, (s, _) in enumerate(sets):
        n = len(s)
        delta[at:at + n, j] = 1
        delta[at + n:at + 2 * n, j] = -1
        at += 2 * n
    order = np.argsort(pos, kind="stable")
    pos, depth = pos[order], np.cumsum(delta[order], axis=0)
    live = (depth[:-1, 0] > 0) & (depth[:-1, 1] == 0) & (depth[:-1, 2] > 0)
    return float(np.sum(np.diff(pos)[live]))


def idle_ms_per_step(ctx, host_span: str):
    """The device's idle time inside ``serve.decode`` spans while the host
    was inside a ``host_span`` span, ms a decode step; None where the trace
    has no device op or the program no such span."""
    decode = span_intervals(ctx, "serve.decode")
    host = span_intervals(ctx, host_span)
    ops = device_intervals(ctx)
    steps = decode_steps(ctx)
    if decode is None or host is None or ops is None or not steps:
        return None
    return idle_inside(decode, ops, host) / 1e3 / steps


def device_ms_per_step(ctx, name: str):
    """The ``device_s`` of the spans named ``name`` over the traced window's
    steps, ms; None where there are none or one is unresolved."""
    steps = len(ctx.records.get("step_s", ()))
    ds = [s.args.get("device_s") for s in ctx.spans if s.name == name]
    if not steps or not ds or None in ds:
        return None
    return sum(ds) * 1e3 / steps
