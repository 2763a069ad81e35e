"""The server's time on a query: the median of the program's
``serve.query`` spans (its plan executed into a table), ms."""

import statistics


def read(ctx):
    spans = ctx.span_seconds("serve.query")
    if not spans:
        return None
    return statistics.median(spans) * 1e3
