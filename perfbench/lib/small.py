"""Cells at sizes a CPU test run can hold: the manifest's cells with their
configurations and traffic shrunk (every other setting as the cell runs
it). Used by the benchmark's own tests."""

from __future__ import annotations

import copy

from perfbench.lib import harness

TABLE = {"rows": 2**14, "rows_per_group": 2**12, "users": {"n": 1024,
                                                           "alpha": 1.2}}
MODEL = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
         "moe_intermediate_size": 32, "num_hidden_layers": 3,
         "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 16,
         "n_routed_experts": 8, "num_experts_per_tok": 2,
         "n_shared_experts": 1}
TRAFFIC = {
    "train": {"seq": 64, "corpus": {"docs": 256, "rows_per_group": 32,
                                    "max_len": 512}},
    "generate": {"batch": 4, "prompt_len": 16, "new_tokens": 8,
                 "max_seq": 24},
}
# cells whose files are kept while BENCHMARK.json leaves them out (PERF.md,
# Open questions); the CPU tests still run them
PARKED = [{"name": "ads-service", "config": "ads-criteo",
           "traffic": "service-4sessions", "chips": 1}]


def small_cell(name: str, root=harness.ROOT) -> harness.Cell:
    manifest = harness.load_manifest(root)
    listed = {w["name"] for w in manifest["workloads"]}
    manifest["workloads"] += [w for w in PARKED if w["name"] not in listed]
    cell = harness.find_cell(manifest, name, root)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if cfg["kind"] == "table":
        cfg.update(copy.deepcopy(TABLE))
    else:
        cfg.update(MODEL)
    shrink = copy.deepcopy(TRAFFIC.get(tr["driver"], {}))
    for q in tr.get("mix", ()):
        if "head" in q:
            q["head"] = 1000
    if "corpus" in shrink:
        tr["corpus"].update(shrink.pop("corpus"))
    tr.update(shrink)
    cell.config, cell.traffic = cfg, tr
    return cell


def run(name: str, seed: int = 2**31 + 17, seconds: float = 1.0,
        trace: bool = False, root=harness.ROOT) -> dict:
    """One run of the small cell on the CPU (``sys.modules`` not looked
    at: a test process may hold JAX)."""
    return harness.run_cell(small_cell(name, root), seed=seed,
                            seconds=seconds, trace=trace, device="cpu",
                            log=lambda *a, **k: None, check_imports=False)
