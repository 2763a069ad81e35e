"""The readings that set ``perfbench/limits/mixtral-stage-generate.json``,
at the cell's own size on the card: the cell's check (``generate_stage.
check``, against the committed limits) of the program's served tokens on
one call, and of the float8 control's (the blocked reference with every
product's operands in float8 e4m3) in their place, on each seed given.

    python3 perfbench/stage_controls.py --seeds 11 12 13

Prints a JSON line a seed: each compared number beside its limit, and
whether the check holds. The program's has to hold, the control's not. The
benchmark's runs do not run this.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def generate(cell, seed: int, device) -> dict:
    """The cell's check of the program's served tokens on one call, and of
    the float8 control's picks in their place."""
    import torch
    from perfbench.lib import harness, stage_models
    from repro_torch.serve import ServeEngine
    drv = harness.load_module("drivers", cell.traffic["driver"])
    cfg, tr = cell.config, cell.traffic
    model = stage_models.build(cfg, seed, device,
                               getattr(torch, cfg["torch_dtype"]))
    p = drv.prompts(cfg, tr, seed, 1)
    toks = ServeEngine(model, max_seq=tr["max_seq"], device=device) \
        .generate(p, tr["new_tokens"])["tokens"]
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    state = drv.State(cfg=cfg, traffic=tr, limits=cell.limits, seed=seed,
                      device=device, sample=(p, toks))
    return {"program": verdict(drv.check(state)),
            "control": verdict(drv.check(
                state, control=drv.reference(state, "fp8")))}


def verdict(checks: dict) -> dict:
    """A check's numbers beside their limits, and whether it holds, by the
    harness's rule (every number at most its limit)."""
    return {**{k: [v, lim] for k, (v, lim) in checks.items()},
            "correct": all(v <= lim for v, lim in checks.values())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="mixtral-stage-generate")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch
    from perfbench.lib import harness
    cell = harness.find_cell(harness.load_manifest(), args.cell)
    for seed in args.seeds:
        out = generate(cell, seed, torch.device("cuda"))
        print(json.dumps({"cell": args.cell, "seed": seed, **out}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
