"""The readings that set a model cell's limits, at the cell's own size on
the card: the control (the plain reference one precision below the
configuration's, in the program's place) and the faults a training step
can have, each on the seeds given, beside the program's own reading on
the same seeds.

    python3 perfbench/controls.py --cell dsmoe-generate --seeds 11 12 13
    python3 perfbench/controls.py --cell dsmoe-train --seeds 11 12 13
    python3 perfbench/controls.py --cell ads-scan --seeds 11 12 13

Prints a JSON line a seed. The benchmark's runs do not run this; it is how
the numbers in ``perfbench/limits/<cell>.json`` were read.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def generate(cell, seed: int, device) -> dict:
    """The program's served stats and the float8 control's, on one call."""
    import torch
    from perfbench.drivers.generate import prompts, served_stats
    from perfbench.lib import models
    from perfbench.reference.moe_lm import Reference
    from repro_torch.serve import ServeEngine
    cfg, tr = cell.config, cell.traffic
    dtype = getattr(torch, cfg["torch_dtype"])
    model = models.build(cfg, seed, device, dtype)
    p = prompts(cfg, tr, seed, 1)
    toks = ServeEngine(model, max_seq=tr["max_seq"], device=device) \
        .generate(p, tr["new_tokens"])["tokens"]
    del model
    _free()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Reference(cfg, seed, device, dtype)
    ctl = Reference(cfg, seed, device, dtype, precision="fp8")
    with torch.no_grad():
        return {"program": served_stats(ref, p, toks),
                "control": served_stats(ref, p, toks, control=ctl)}


def table(cell, seed: int, device) -> dict:
    """Entries of the cell's answers that the controls change: the
    reference with float8 in place of the stored BF16 features, and with
    the deletes left out, each against the reference, over every query of
    the traffic's mix (probes at the seed's first users)."""
    import numpy as np
    from perfbench.gen import criteo
    from perfbench.reference.table import TableReference, mismatches
    cols = criteo.columns(cell.config, seed, device)
    victims = criteo.victims(cell.config, cols, seed)
    want = TableReference(cols, criteo.DENSE, victims)
    tr = cell.traffic
    if "predicates" in tr:
        queries = [(tr["columns"], p["where"], None) for p in tr["predicates"]]
    else:
        users = np.unique(cols["user_id"])[:3]
        queries = [(q["columns"], list(q.get("where", ()))
                    + ([[q["probe"], "==", int(u)]] if "probe" in q else []),
                    q.get("head")) for q, u in zip(tr["mix"], [0, 0, *users])]
    out = {}
    for name, ctl in (("control_fp8", TableReference(cols, criteo.DENSE,
                                                     victims, "fp8")),
                      ("fault_no_delete", TableReference(
                          cols, criteo.DENSE, victims, delete=False))):
        out[name] = [mismatches(ctl.query(*q), want.query(*q))
                     for q in queries]
    return out


def train(cell, seed: int, device, fault: str = "") -> dict:
    """The program's three numbers (with ``fault`` planted: ``half``, half
    of each batch left out, the mean over the rest), and, unplanted, the
    TF32 control's."""
    import torch
    from perfbench.drivers import train as drv
    from perfbench.lib.harness import Stages
    from perfbench.reference import loader as loader_ref
    from repro_torch.models import zoo
    real = zoo.Model.loss
    if fault == "half":
        def half(self, batch):
            t = batch["tokens"]
            return real(self, {"tokens": t[: len(t) // 2]})
        zoo.Model.loss = half
    try:
        state = drv.setup(cell, seed, device, Stages(0.0))
    finally:
        zoo.Model.loss = real
    drv.release(state)
    _free()
    tr = cell.traffic
    batches = loader_ref.batches(state.docs, tr["min_quality"], tr["batch"],
                                 tr["seq"], 0, drv.WARM_STEPS)
    drv._tf32_off()
    ref = drv.reference_steps(cell.config, tr, seed, device, batches)
    out = drv.compare(state.losses, state.grad_norms, state.change_norms,
                      *ref)
    out["losses"] = [state.losses, ref[0]]
    out["worst_leaves"] = _worst_leaves(state, ref)
    if not fault:
        _free()
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            ctl = drv.reference_steps(cell.config, tr, seed, device, batches)
        finally:
            drv._tf32_off()
        out["control"] = drv.compare(*ctl, *ref)
    return out


def _worst_leaves(state, ref, n: int = 4) -> dict:
    """The leaves of largest gap in each norm, with both norms."""
    import numpy as np
    _, ref_grads, ref_change = ref
    out = {}
    for name, got, want in (("first_grad", state.grad_norms, ref_grads),
                            ("change", state.change_norms, ref_change)):
        med = float(np.median(list(want.values())))
        gaps = sorted(((abs(got[k] - v) / max(v, med), k, got[k], v)
                       for k, v in want.items()), reverse=True)[:n]
        out[name] = [[k, g, a, b] for g, k, a, b in gaps]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="", choices=("", "half"))
    args = ap.parse_args()
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch
    from perfbench.lib import harness
    cell = harness.find_cell(harness.load_manifest(), args.cell)
    dev = torch.device("cuda")
    for seed in args.seeds:
        driver = cell.traffic["driver"]
        if driver == "generate":
            out = generate(cell, seed, dev)
        elif driver == "train":
            out = train(cell, seed, dev, args.fault)
        else:
            out = table(cell, seed, dev)
        print(json.dumps({"cell": args.cell, "seed": seed,
                          "fault": args.fault, **out}), flush=True)
        _free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
