"""A decode step: the untraced window's total ``decode_s``
(``ServeEngine.generate``'s host clock around its decode loop, closed by a
synchronise) over its decode steps, ms. The traced window is not read:
the profiler slows a step that the host's dispatch bounds."""


def read(ctx):
    calls = ctx.plain.get("calls")
    if not calls:
        return None
    steps = len(calls) * ctx.plain["new_tokens"]
    return sum(c["decode_s"] for c in calls) * 1e3 / steps
