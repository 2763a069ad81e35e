"""The wire's share of a query: the median over queries of the client's
latency less the server's own wall time for that query (the
``wall_seconds`` its reply carries): framing, base64 JSON both ways, the
socket, the client's decode, ms. Read in the untraced window."""

import statistics


def read(ctx):
    qs = [lat - srv for _, lat, srv in ctx.plain.get("queries", ())
          if srv is not None]
    if not qs:
        return None
    return statistics.median(qs) * 1e3
