"""Reading a scan's pages: the program's ``decode.pread`` spans, ms per
scan."""


def read(ctx):
    scans = len(ctx.records.get("scans", ()))
    spans = ctx.span_seconds("decode.pread")
    if not scans or not spans:
        return None
    return sum(spans) * 1e3 / scans
