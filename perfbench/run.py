"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared with the plain reference beside its limit. Those checks
are also the last lines of standard error. The split of the set-up by
stage is printed on standard error before them.

Exits 2, printing no result, without a CUDA card (or fewer than the cell
asks for), where the run has imported JAX or the JAX package, or where the
program (``src/repro_torch``) is absent.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through
    libraries that would load it."""
    cache = ROOT / "build" / "perfbench-cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from perfbench.lib import harness
    try:
        cell = harness.find_cell(harness.load_manifest(ROOT), args.workload)
        result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                                  trace=bool(args.trace), t0=T0)
    except (harness.BenchError, ImportError) as e:
        print(f"perfbench: no result: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
