"""The share of decode steps replayed from a captured CUDA graph: the
``serve.decode`` spans' ``graph_steps`` over their ``steps``, %. Spans
that carry no ``graph_steps`` (a program that takes no graph) read
nothing."""


def read(ctx):
    decode = [s for s in ctx.spans if s.name == "serve.decode"]
    steps = sum(int(s.args.get("steps", 0)) for s in decode)
    if not steps or any("graph_steps" not in s.args for s in decode):
        return None
    return 100.0 * sum(int(s.args["graph_steps"]) for s in decode) / steps
