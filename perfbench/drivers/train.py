"""Driver of a training job fed by the column store: ``make_train_step``
with AdamW, its batches from ``BullionLoader`` over a corpus the program's
writer wrote in set-up, filtered by quality on the card, as
``launch/train.py``'s ``main`` feeds it (the loss read back every step).

Set-up builds one step object and drives it through its first three steps
on the loader's batches (the warm-up, and the steps the reference
follows); the window continues with the same object and loader.
End-to-end: ``train_tokens_per_s``, the tokens of every step completed in
the window over the window (it ends with the step in which ``seconds``
have passed).

Correct: every batch the loader delivered equals the reference stream's;
the plain float32 reference then takes the same three steps from the same
weights, and each step's loss, each leaf's norm of the first (clipped)
gradient as the optimizer got it (from its first moment after step 1),
and each leaf's norm of the change over the three steps are compared.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np

from perfbench.gen import corpus
from perfbench.lib import models
from perfbench.lib.harness import Window
from perfbench.reference import loader as loader_ref

WARM_STEPS = 3


@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    device: object
    tmp: str = ""
    docs: dict = None
    model: object = None
    step: object = None
    opt: dict = None
    loader: object = None
    it: object = None
    batches: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)
    grad_norms: dict = None        # leaf -> norm of the clipped first gradient
    change_norms: dict = None      # leaf -> norm of the change over 3 steps


def _tf32_off():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _corpus_cfg(cfg, tr) -> dict:
    return dict(tr["corpus"], vocab=cfg["vocab_size"])


def _leaf_norms(cfg, tensors: dict) -> dict:
    """{(layer, logical name): norm} of the program's named tensors."""
    import torch
    out = {}
    for layer in range(-1, cfg["num_hidden_layers"]):
        for logical, prog in models.program_names(cfg, layer).items():
            out[f"{layer}.{logical}"] = float(
                torch.linalg.vector_norm(tensors[prog].float()))
    return out


def setup(cell, seed, device, stages) -> State:
    import torch
    from repro_torch.data import BullionLoader
    from repro_torch.scan import C
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    _tf32_off()
    cfg, tr = cell.config, cell.traffic
    state = State(cfg=cfg, traffic=tr, limits=cell.limits, seed=seed,
                  device=device)
    state.docs = corpus.documents(_corpus_cfg(cfg, tr), seed)
    state.tmp = tempfile.mkdtemp(prefix="pb-")
    path = os.path.join(state.tmp, "corpus.bln")
    corpus.write(_corpus_cfg(cfg, tr), state.docs, path)
    stages.mark("data_write")
    state.model = models.build(cfg, seed, device, torch.float32)
    stages.mark("weights")
    opt_cfg = AdamWConfig(**tr["optimizer"])
    state.opt = adamw_init(state.model)
    state.step = make_train_step(state.model, opt_cfg, device=device)
    state.loader = BullionLoader(path, batch_size=tr["batch"],
                                 seq_len=tr["seq"], prefetch=2,
                                 predicate=C("quality") >= tr["min_quality"],
                                 device=device)
    state.it = iter(state.loader)
    params = dict(state.model.named_parameters())
    for i in range(WARM_STEPS):
        batch, _ = next(state.it)
        state.batches.append(batch)
        out = state.step(state.opt, {"tokens": batch})
        state.losses.append(float(out["loss"]))
        if i == 0:
            inv = 1.0 / (1.0 - opt_cfg.b1)
            state.grad_norms = _leaf_norms(
                cfg, {k: m * inv for k, m in state.opt["m"].items()})
    # the change over the three steps, against the weights made again
    with torch.no_grad():
        state.change_norms = {}
        for layer in range(-1, cfg["num_hidden_layers"]):
            p0 = models.program_params(cfg, seed, layer, device, torch.float32)
            names = models.program_names(cfg, layer)
            state.change_norms.update({
                f"{layer}.{logical}": float(torch.linalg.vector_norm(
                    params[prog] - p0[prog]))
                for logical, prog in names.items()})
            del p0
    stages.mark("warmup")
    return state


def window(state: State, seconds: float) -> Window:
    from torch.profiler import record_function
    tr = state.traffic
    waits, steps = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t1 = time.perf_counter()
        with record_function("bench.loader_next"):
            batch, _ = next(state.it)
        t2 = time.perf_counter()
        with record_function("bench.train_step"):
            out = state.step(state.opt, {"tokens": batch})
            float(out["loss"])
        t3 = time.perf_counter()
        waits.append(t2 - t1)
        steps.append(t3 - t1)
        state.batches.append(batch)
    window_s = time.perf_counter() - t0
    tokens = len(steps) * tr["batch"] * tr["seq"]
    return Window(attempted=len(steps), failed=0,
                  end_to_end={"train_tokens_per_s": tokens / window_s},
                  records={"loader_wait_s": waits, "step_s": steps,
                           "batch": tr["batch"], "seq": tr["seq"],
                           "cfg": state.cfg})


def release(state: State) -> None:
    if state.loader is not None:
        state.loader.close()
    state.loader = state.it = state.step = state.opt = state.model = None
    shutil.rmtree(state.tmp, ignore_errors=True)


def _median(xs):
    return float(np.median(list(xs)))


def reference_steps(cfg, tr, seed, device, batches):
    """The reference's three steps: (losses, {leaf: norm of the clipped
    first gradient}, {leaf: norm of the change}), in the precision the
    matmul flags allow (the control turns TF32 on)."""
    import torch
    from perfbench.reference.adamw import AdamW
    from perfbench.reference.moe_lm import Reference
    ref = Reference(cfg, seed, device, torch.float32)
    params = {}
    for layer in range(-1, cfg["num_hidden_layers"]):
        params[layer] = {k: v.clone().requires_grad_(True)
                         for k, v in ref.weights(layer).items()}
    flat = {f"{layer}.{k}": v for layer, w in params.items()
            for k, v in w.items()}
    opt = AdamW(flat, **tr["optimizer"])
    losses, first = [], None
    for i, batch in enumerate(batches[:WARM_STEPS]):
        tokens = torch.as_tensor(np.asarray(batch, np.int64), device=device)
        loss = ref.loss(params, tokens)
        grads = torch.autograd.grad(loss, list(flat.values()))
        norms = opt.step(dict(zip(flat, grads)))
        losses.append(float(loss.detach()))
        if i == 0:
            first = norms
        del grads, loss
    with torch.no_grad():
        change = {}
        for layer in range(-1, cfg["num_hidden_layers"]):
            for k, v in ref.weights(layer).items():
                change[f"{layer}.{k}"] = float(torch.linalg.vector_norm(
                    params[layer][k].detach() - v))
    return losses, first, change


def compare(losses, grads, change, ref_losses, ref_grads, ref_change) -> dict:
    """The three numbers, each the worst over steps or leaves: the loss's
    gap relative to the reference's; each leaf's gap of norms relative to
    the larger of its reference norm and the median leaf's; the change over
    leaves whose reference gradient is at least a thousandth of the median
    leaf's (the others move by round-off alone under Adam)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    med_g = _median(ref_grads.values())
    grad_gap = max(abs(grads[k] - v) / max(v, med_g)
                   for k, v in ref_grads.items())
    moved = [k for k, v in ref_grads.items() if v >= 1e-3 * med_g]
    med_c = _median(ref_change[k] for k in moved)
    change_gap = max(abs(change[k] - ref_change[k]) / max(ref_change[k], med_c)
                     for k in moved)
    return {"loss_gap": loss_gap, "first_grad_gap": grad_gap,
            "change_gap": change_gap}


def check(state: State) -> dict:
    _tf32_off()
    tr = state.traffic
    want = loader_ref.batches(state.docs, tr["min_quality"], tr["batch"],
                              tr["seq"], 0, len(state.batches))
    bad = sum(not np.array_equal(a, b) for a, b in zip(state.batches, want))
    ref = reference_steps(state.cfg, tr, state.seed, state.device, want)
    gaps = compare(state.losses, state.grad_norms, state.change_norms, *ref)
    lim = state.limits
    return {"loader_batches_differing": (bad, 0),
            **{k: (v, lim[k]) for k, v in gaps.items() if k in lim}}
