"""Planning a scan: the program's ``plan.optimize`` and ``plan.lower``
spans (projection, zone-map pruning, lowering to tasks), ms per scan."""


def read(ctx):
    scans = len(ctx.records.get("scans", ()))
    spans = ctx.span_seconds("plan.optimize", "plan.lower")
    if not scans or not spans:
        return None
    return sum(spans) * 1e3 / scans
