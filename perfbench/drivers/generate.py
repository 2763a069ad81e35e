"""Driver of offline batch generation: ``ServeEngine.generate`` called back
to back, each call a new batch of prompts drawn from the seed (Zipf
tokens over the vocabulary), greedy.

End-to-end: ``gen_tokens_per_s``, the tokens of every completed call over
the calls' total wall time; the window ends with the call in which
``seconds`` have passed. Correct: one completed call, drawn from the seed,
is run again by the plain reference (float32, the benchmark's weights made
again layer by layer from the seed, the same calls' capacities), and each
served token's reference logit is compared with the reference's best at
its position: the widest gap must stay under the limit.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from perfbench.lib import models
from perfbench.lib.harness import Window


@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    device: object
    model: object = None
    engine: object = None
    sample: tuple = None          # (prompts, tokens) of the call kept
    calls: list = dataclasses.field(default_factory=list)


def prompts(cfg: dict, traffic: dict, seed: int, call: int) -> np.ndarray:
    """Call ``call``'s prompts [B, P] (0: the warm-up's): Zipf(1) token ids
    (log-uniform ranks over the vocabulary), one seeded draw."""
    rng = np.random.default_rng([seed, 7, call])
    B, P, V = traffic["batch"], traffic["prompt_len"], cfg["vocab_size"]
    u = rng.random((B, P))
    return (np.exp(u * np.log(V + 1.0)).astype(np.int64) - 1) \
        .clip(0, V - 1).astype(np.int32)


def setup(cell, seed, device, stages) -> State:
    import torch
    from repro_torch.serve import ServeEngine
    tr = cell.traffic
    dtype = getattr(torch, cell.config["torch_dtype"])
    state = State(cfg=cell.config, traffic=tr, limits=cell.limits, seed=seed,
                  device=device)
    state.model = models.build(cell.config, seed, device, dtype)
    stages.mark("weights")
    state.engine = ServeEngine(state.model, max_seq=tr["max_seq"],
                               device=device)
    # the window's shapes: one call at its batch, prompt and length
    state.engine.generate(prompts(cell.config, tr, seed, 0),
                          tr["new_tokens"])
    stages.mark("warmup")
    return state


def window(state: State, seconds: float) -> Window:
    from torch.profiler import record_function
    tr = state.traffic
    pick = np.random.default_rng([state.seed, 8])
    t0 = time.perf_counter()
    wall, n = 0.0, 0
    while time.perf_counter() - t0 < seconds:
        p = prompts(state.cfg, tr, state.seed, n + 1)
        t1 = time.perf_counter()
        with record_function("bench.generate"):
            out = state.engine.generate(p, tr["new_tokens"])
        wall += time.perf_counter() - t1
        n += 1
        state.calls.append({"prefill_s": out["prefill_s"],
                            "decode_s": out["decode_s"]})
        if pick.random() * n < 1.0:
            state.sample = (p, out["tokens"])
    tokens = n * tr["batch"] * tr["new_tokens"]
    return Window(attempted=n, failed=0,
                  end_to_end={"gen_tokens_per_s": tokens / wall},
                  records={"calls": state.calls, "batch": tr["batch"],
                           "prompt_len": tr["prompt_len"],
                           "new_tokens": tr["new_tokens"], "cfg": state.cfg})


def release(state: State) -> None:
    state.engine = None
    state.model = None


def served_stats(ref, prompts_, tokens, control=None) -> dict:
    """How far the served tokens lie below the reference's best at their
    positions (reference logits, f32): ``widest`` the widest gap, ``mean``
    the mean gap over every served position, ``worst_request`` the largest
    of the requests' mean gaps, ``not_first`` the share of positions whose
    served token is not the reference's first. With a
    ``control`` Reference, the same of the tokens the control puts
    first."""
    import torch
    P = prompts_.shape[1]
    seq = np.concatenate([prompts_, tokens[:, :-1]], axis=1)
    t = torch.as_tensor(seq, dtype=torch.long, device=ref.device)
    logits = ref.served_logits(t, P)
    if control is not None:
        pick = control.served_logits(t, P).argmax(dim=-1)
    else:
        pick = torch.as_tensor(tokens, dtype=torch.long, device=ref.device)
    best = logits.max(dim=-1).values
    gap = best - logits.gather(-1, pick[..., None])[..., 0]     # [B, n]
    return {"widest": float(gap.max()), "mean": float(gap.mean()),
            "worst_request": float(gap.mean(dim=1).max()),
            "not_first": float((gap > 0).float().mean())}


def check(state: State) -> dict:
    """The served sample against the reference: the mean over the call's
    served positions of the gap below the reference's best (the widest
    gap and the worst request's mean gap have no upper reading: see
    ``perfbench/limits/dsmoe-generate.json``)."""
    import torch
    from perfbench.reference.moe_lm import Reference
    lim = state.limits
    if state.sample is None:
        return {k: (1e30, lim[k]) for k in NUMBERS}      # no call completed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Reference(state.cfg, state.seed, state.device,
                    getattr(torch, state.cfg["torch_dtype"]))
    with torch.no_grad():
        stats = served_stats(ref, *state.sample)
    return {k: (stats[s], lim[k]) for k, s in NUMBERS.items()}


# the compared numbers and the statistic each is
NUMBERS = {"served_mean_gap": "mean"}
