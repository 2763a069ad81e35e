"""Host page decode of a scan: the program's ``decode.decode`` and
``decode.mask`` spans (encodings, then the deletion masks), summed over
the threads that ran them, ms per scan."""


def read(ctx):
    scans = len(ctx.records.get("scans", ()))
    spans = ctx.span_seconds("decode.decode", "decode.mask")
    if not scans or not spans:
        return None
    return sum(spans) * 1e3 / scans
