"""What tracing costs when it is on, in one cell: a ``--trace 1`` run of
the benchmark (an untraced window, then a traced one of the same length,
the program's spans collected and the profiler on), printing each window's
end-to-end metrics beside the run's per-layer metrics, as one JSON line.

    python3 tools/trace_cost.py --root CHECKOUT --workload dsmoe-generate \\
        --seed 4200000101 --seconds 30

``--root`` is the checkout whose ``perfbench/`` and ``src/`` run (another
commit unpacked into an ignored directory, to compare two). Needs a card.
"""

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from perfbench import run as bench
    bench._environment()            # the benchmark's own caches and paths
    from perfbench.lib import harness
    cell = harness.find_cell(harness.load_manifest(harness.ROOT),
                             args.workload)
    traffic = harness.load_module("drivers", cell.traffic["driver"])
    windows = []
    window = traffic.window

    def recorded(state, seconds):
        win = window(state, seconds)
        windows.append(dict(win.end_to_end))
        return win
    traffic.window = recorded       # run_cell finds the same module
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                              trace=True, t0=T0)
    untraced, traced = windows
    print(json.dumps({"root": root, "workload": args.workload,
                      "seed": args.seed, "untraced": untraced,
                      "traced": traced,
                      "traced_over_untraced": {
                          k: traced[k] / untraced[k] for k in untraced},
                      "correct": result["correct"],
                      "metrics": result["metrics"],
                      "device": result["device"],
                      "breakdown": result.get("breakdown")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
