"""Driver of the dataset service: a ``DatasetServer`` on a local socket and
closed-loop client sessions (``ServeClient``), each in a thread of its own,
sending its next query once the reply to the last has come, repeating the
traffic file's mix, probe literals drawn from the seed.

End-to-end: ``query_p95_ms``, the 95th percentile of the client-side
latency of every query completed in the window (a session sends no query
after ``seconds``; the ones in flight complete and count). The completed
queries over the window, and each kind's latency, go to standard error.
Correct: every
probe's reply, and a seeded sample of the range and projection replies,
equal bit for bit to the NumPy reference on the generator's columns.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np

from perfbench.lib import tables
from perfbench.lib.harness import Window
from perfbench.reference.table import mismatches


@dataclasses.dataclass
class State:
    table: tables.Table
    traffic: dict
    seed: int
    users: np.ndarray
    server: object = None
    clients: list = dataclasses.field(default_factory=list)
    kept: list = dataclasses.field(default_factory=list)   # (spec, literal, reply)
    failed: int = 0


def _query(spec: dict, literal):
    """A mix entry as ``query`` keyword arguments (the program's form) and
    its conjunction (the reference's)."""
    where = list(spec.get("where", ()))
    if "probe" in spec:
        where.append([spec["probe"], "==", int(literal)])
    kw = {"columns": spec["columns"], "where": tables.predicate(where)}
    if "head" in spec:
        kw["head"] = spec["head"]
    return kw, where


def setup(cell, seed, device, stages) -> State:
    from repro_torch.serve import DatasetServer, ServeClient
    tr = cell.traffic
    table = tables.make(cell.config, seed, device, stages)
    state = State(table=table, traffic=tr, seed=seed,
                  users=np.unique(table.columns["user_id"]))
    state.server = DatasetServer({"t": table.path}, device=device,
                                 max_workers=tr["pool"])
    sock = state.server.serve(os.path.join(table.tmp, "s.sock"))
    state.clients = [ServeClient(sock, timeout=600)
                     for _ in range(tr["sessions"])]
    # one query of each kind: plans prepared, kernels loaded
    seen = set()
    for spec in tr["mix"]:
        if spec["kind"] not in seen:
            seen.add(spec["kind"])
            state.clients[0].query("t", **_query(spec, state.users[0])[0])
    stages.mark("warmup")
    return state


def window(state: State, seconds: float) -> Window:
    from torch.profiler import record_function
    tr = state.traffic
    mix = tr["mix"]
    results = [[] for _ in state.clients]
    failed = [0]
    lock = threading.Lock()
    seen: dict = {}
    pick = np.random.default_rng([state.seed, 9])
    t0 = time.perf_counter()

    def session(i: int) -> None:
        rng = np.random.default_rng([state.seed, 10, i])
        client = state.clients[i]
        j = 0
        while time.perf_counter() - t0 < seconds:
            spec = mix[j % len(mix)]
            j += 1
            literal = rng.choice(state.users) if "probe" in spec else None
            kw, _ = _query(spec, literal)
            t1 = time.perf_counter()
            with record_function("bench.query"):
                try:
                    reply = client.query("t", **kw)
                except Exception as e:          # an answer that never comes
                    reply = e
            lat = time.perf_counter() - t1
            server_s = getattr(reply, "wall_seconds", None)
            results[i].append((spec["kind"], lat, server_s))
            with lock:
                if isinstance(reply, Exception):
                    state.failed += 1
                    failed[0] += 1
                    state.kept.append((spec, literal, None))
                    continue
                k = spec["kind"]
                seen[k] = seen.get(k, 0) + 1
                cap = tr["keep"].get(k)
                if cap is None:
                    state.kept.append((spec, literal, reply.table))
                elif seen[k] <= cap:
                    state.kept.append((spec, literal, reply.table))
                elif pick.random() * seen[k] < cap:
                    # reservoir: replace one of this kind's kept replies
                    slots = [n for n, (s, _, _) in enumerate(state.kept)
                             if s["kind"] == k]
                    state.kept[slots[int(pick.integers(len(slots)))]] = \
                        (spec, literal, reply.table)

    threads = [threading.Thread(target=session, args=(i,))
               for i in range(len(state.clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    queries = [r for rs in results for r in rs]
    lat = np.array([r[1] for r in queries])
    done = len(lat) - failed[0]
    p95_ms = float(np.percentile(lat, 95)) * 1e3
    by_kind = {}
    for k in dict.fromkeys(r[0] for r in queries):
        ks = np.array([r[1] for r in queries if r[0] == k]) * 1e3
        by_kind[k] = {"n": len(ks), "p50_ms": float(np.median(ks)),
                      "p95_ms": float(np.percentile(ks, 95))}
    print(json.dumps({"service": {
        "completed": done, "window_s": elapsed, "queries_per_s": done / elapsed,
        "p95_ms": p95_ms, "by_kind": by_kind}}), file=sys.stderr)
    return Window(attempted=len(lat), failed=failed[0],
                  end_to_end={"query_p95_ms": p95_ms},
                  records={"queries": queries})


def release(state: State) -> None:
    for c in state.clients:
        c.close()
    if state.server is not None:
        state.server.close()
    state.clients, state.server = [], None
    state.table.remove()


def check(state: State, reference=None) -> dict:
    """``{"reply_mismatches": (entries of the kept replies differing from
    the reference, 0), "queries_failed": (queries that raised, 0)}``."""
    ref = reference or state.table.reference()
    bad = 0
    for spec, literal, got in state.kept:
        kw, where = _query(spec, literal)
        want = ref.query(spec["columns"], where, spec.get("head"))
        bad += mismatches(got, want) if got is not None \
            else sum(len(v) for v in want.values()) or 1
    return {"reply_mismatches": (bad, 0), "queries_failed": (state.failed, 0)}
