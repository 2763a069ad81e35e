"""Driver of table scans: ``dataset(path).select(columns).where(p)
.dequantized().to_table()`` back to back, one process, one thread of
calls, the traffic file's predicates in a seeded order: each round of
scans is a permutation of them, and the window ends with the round in
which ``seconds`` have passed, so every seed does the same work.

End-to-end: ``scan_rows_per_s``, the table's rows a completed scan ranged
over (pruned row groups count as covered), summed over the window, over the
window. Correct: a seeded sample of each predicate's results (one each,
reservoir-sampled over the window) equal, bit for bit, to the NumPy
reference on the generator's columns.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from perfbench.gen import criteo
from perfbench.lib import tables
from perfbench.lib.harness import Window
from perfbench.reference.table import mismatches


@dataclasses.dataclass
class State:
    table: tables.Table
    device: object
    seed: int
    preds: list            # (name, where, program predicate)
    columns: list
    samples: dict = dataclasses.field(default_factory=dict)  # i -> table
    failed: int = 0


def _scan(state: State, pred):
    from repro_torch.dataset import dataset
    with dataset(state.table.path, device=state.device) as ds:
        return ds.select(state.columns).where(pred).dequantized(True) \
            .to_table()


def setup(cell, seed, device, stages) -> State:
    tr = cell.traffic
    table = tables.make(cell.config, seed, device, stages)
    preds = [(p["name"], p["where"], tables.predicate(p["where"]))
             for p in tr["predicates"]]
    state = State(table=table, device=device, seed=seed, preds=preds,
                  columns=list(tr["columns"]))
    # every code path the window takes: a predicate the host evaluates on a
    # pruned table, one the range-filter kernel evaluates; both dequantize
    # through the column-list kernel and apply the deletion vectors
    for i in tr["warmup"]:
        _scan(state, preds[i][2])
    stages.mark("warmup")
    return state


def window(state: State, seconds: float) -> Window:
    from torch.profiler import record_function
    order_rng = np.random.default_rng([state.seed, 3])
    pick_rng = np.random.default_rng([state.seed, 4])
    seen = [0] * len(state.preds)
    order, scans = [], []
    t0 = time.perf_counter()
    while True:
        if not order:
            if time.perf_counter() - t0 >= seconds:
                break
            order = list(order_rng.permutation(len(state.preds)))
        i = int(order.pop(0))
        t1 = time.perf_counter()
        with record_function("bench.scan"):
            try:
                out = _scan(state, state.preds[i][2])
            except Exception as e:            # an answer that never comes
                state.failed += 1
                out = e
        t2 = time.perf_counter()
        seen[i] += 1
        if pick_rng.random() * seen[i] < 1.0:
            state.samples[i] = out
        scans.append((i, t2 - t1))
    window_s = t2 - t0
    n_rows = int(state.table.cfg["rows"])
    work = {name: tables.evaluated(state.table, where)
            for name, where, _ in state.preds}
    return Window(attempted=len(scans), failed=state.failed,
                  end_to_end={"scan_rows_per_s": len(scans) * n_rows
                              / window_s},
                  records={"scans": [(state.preds[i][0], s) for i, s in scans],
                           "evaluated_rows": work,
                           "filter_terms": {
                               n: len(w) if w and all(c in criteo.DENSE
                                                      for c, _, _ in w) else 0
                               for n, w, _ in state.preds},
                           "quantized": state.table.cfg["dense"]["n"]})


def release(state: State) -> None:
    state.table.remove()


def check(state: State, reference=None) -> dict:
    """``{"scan_mismatches": (entries differing from the reference in the
    sampled results, 0), "scans_failed": (scans that raised, 0)}``.
    ``reference`` (default: the configuration's) may be another
    ``TableReference``, for the control."""
    ref = reference or state.table.reference()
    bad = 0
    for i, got in state.samples.items():
        _, where, _ = state.preds[i]
        want = ref.query(state.columns, where)
        bad += mismatches(got, want) if isinstance(got, dict) \
            else sum(len(v) for v in want.values()) or 1
    return {"scan_mismatches": (bad, 0), "scans_failed": (state.failed, 0)}
