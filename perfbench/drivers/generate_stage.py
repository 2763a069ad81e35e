"""Driver of offline batch generation on a pipeline stage whose layers are
too large for the generic bridge and reference: ``generate.py``'s traffic,
window, release and served statistics, with the stage bridge
(``perfbench/lib/stage_models.py``: no layer's draw outlives it) and the
blocked reference (``perfbench/reference/moe_lm_blocked.py``: attention a
batch row at a time).

End-to-end and correct as in ``generate.py``: ``gen_tokens_per_s``; the mean
gap of one completed call's served tokens below the reference's best
logit at their positions (float32, TF32 off). A window's records hold its
own calls alone.
"""

from __future__ import annotations

from perfbench.lib import harness, stage_models

_gen = harness.load_module("drivers", "generate")
State, prompts, release = _gen.State, _gen.prompts, _gen.release
served_stats, NUMBERS = _gen.served_stats, _gen.NUMBERS


def setup(cell, seed, device, stages) -> State:
    import torch
    from repro_torch.serve import ServeEngine
    tr = cell.traffic
    dtype = getattr(torch, cell.config["torch_dtype"])
    state = State(cfg=cell.config, traffic=tr, limits=cell.limits, seed=seed,
                  device=device)
    state.model = stage_models.build(cell.config, seed, device, dtype)
    stages.mark("weights")
    state.engine = ServeEngine(state.model, max_seq=tr["max_seq"],
                               device=device)
    # the window's shapes: one call at its batch, prompt and length
    state.engine.generate(prompts(cell.config, tr, seed, 0),
                          tr["new_tokens"])
    stages.mark("warmup")
    return state


def window(state: State, seconds: float):
    """``generate.py``'s window, its records holding this window's calls
    alone: ``generate.py``'s hold every call so far, so that in a traced
    run the readers of the untraced window would read the traced calls
    too."""
    before = len(state.calls)
    win = _gen.window(state, seconds)
    win.records = dict(win.records, calls=state.calls[before:])
    return win


def reference(state: State, precision: str = "fp32"):
    """The blocked plain reference of the cell's configuration and seed."""
    import torch
    from perfbench.reference.moe_lm_blocked import Reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Reference(state.cfg, state.seed, state.device,
                     getattr(torch, state.cfg["torch_dtype"]),
                     precision=precision)


def check(state: State, control=None) -> dict:
    """The served sample against the blocked reference: the mean over the
    call's served positions of the gap below the reference's best (see
    ``perfbench/limits/mixtral-stage-generate.json``). With a ``control``
    Reference, the tokens it puts first at those positions in the served
    tokens' place (``perfbench/stage_controls.py``)."""
    import torch
    lim = state.limits
    if state.sample is None:
        return {k: (1e30, lim[k]) for k in NUMBERS}      # no call completed
    with torch.no_grad():
        stats = served_stats(reference(state), *state.sample,
                             control=control)
    return {k: (stats[s], lim[k]) for k, s in NUMBERS.items()}
