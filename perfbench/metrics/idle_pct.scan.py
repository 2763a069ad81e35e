"""The device's idle share of the traced window: 100 less the share in
which some operation ran on it (the union of the profiler's device
intervals)."""


def read(ctx):
    if not ctx.window_s or ctx.busy_s is None or not ctx.kernels:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
