"""The benchmark's harness: one run of one cell.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is found by its name in ``BENCHMARK.json``:

- ``perfbench/configs/<config>.json``: the configuration as it is run;
- ``perfbench/traffic/<traffic>.json``: the traffic mix's parameters and
  the name of the driver (``perfbench/drivers/<driver>.py``) that offers
  them to the program;
- ``perfbench/metrics/<metric>.py``: a reader ``read(ctx)`` of one
  per-layer metric, returning a number, or None where it finds nothing;
- ``perfbench/limits/<cell>.json``: the limit of each number the cell's
  check compares with the plain reference, with the readings it was set
  from.

A driver has four functions: ``setup(cell, seed, device, stages)`` builds
the system under test and warms every shape the window uses, ``window(state,
seconds)`` offers the traffic for ``seconds`` and returns a ``Window``,
``release(state)`` frees the program's state, and ``check(state)`` compares
what the window produced with the plain reference, returning
``{name: (value, limit)}``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parents[2]
# top-level module names that no run may hold: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "repro")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# the prefix of the benchmark's own ``record_function`` ranges
ANNOTATION = "bench."


class BenchError(RuntimeError):
    """The run cannot report a result (no card, a JAX import, a bad name)."""


# ---------------------------------------------------------------------------
# names and files
# ---------------------------------------------------------------------------


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named_file(root: Path, kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise BenchError(f"bad {kind} name {name!r}")
    path = root / "perfbench" / kind / f"{name}{suffix}"
    if not path.is_file():
        raise BenchError(f"no {kind} file {path.relative_to(root)}")
    return path


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    return json.loads(_named_file(root, kind, name, ".json").read_text())


def load_module(kind: str, name: str, root: Path = ROOT):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold ``-`` and
    ``.``, so it is loaded by path)."""
    path = _named_file(root, kind, name, ".py")
    key = f"perfbench_{kind}_" + re.sub(r"\W", "_", name)
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: list        # the manifest's end-to-end metrics this cell reports
    per_layer: list         # the manifest's per-layer metrics this cell reports
    limits: dict            # perfbench/limits/<cell>.json: each check's limit


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def find_cell(manifest: dict, name: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if _reports(m, name, names)]
    return Cell(name=name, config_name=w["config"],
                config=load_json("configs", w["config"], root),
                traffic_name=w["traffic"],
                traffic=load_json("traffic", w["traffic"], root),
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer,
                limits=load_json("limits", name, root))


# ---------------------------------------------------------------------------
# the guard against JAX
# ---------------------------------------------------------------------------


def banned_modules(names) -> list[str]:
    """The banned top-level names among module names, each compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".", 1)[0] for n in names} & set(BANNED))


def guard() -> None:
    found = banned_modules(list(sys.modules))
    if found:
        raise BenchError(f"the run imported {', '.join(found)}")


# ---------------------------------------------------------------------------
# set-up by stage
# ---------------------------------------------------------------------------


def process_age() -> Optional[float]:
    """Seconds since this process started (Linux), None elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class Stages:
    """Set-up split by stage: ``mark(name)`` closes the stage that ran since
    the last mark. The first stage starts when the process did."""

    def __init__(self, t0: float):
        age = process_age()
        self.t_start = time.perf_counter() - age if age is not None else t0
        self._last = self.t_start
        self.seconds: dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._last
        self._last = now

    def total(self) -> float:
        return time.perf_counter() - self.t_start


# ---------------------------------------------------------------------------
# the window's result and the device trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Window:
    attempted: int
    failed: int
    end_to_end: dict                      # metric name -> value
    records: dict = dataclasses.field(default_factory=dict)   # for readers


@dataclasses.dataclass
class TraceCtx:
    """What a per-layer reader reads: the cell, the driver's records of the
    traced window, the program's spans there (``obs.trace`` records) and
    the device trace; and the records and length of the untraced window
    that precedes it (``plain``, ``plain_s``), for readings by the host's
    clock, which the profiler would slow."""
    cell: Cell
    records: dict
    spans: list
    kernels: list          # (name, start_us, dur_us) of each device op
    busy_s: float
    window_s: float
    plain: dict = dataclasses.field(default_factory=dict)
    plain_s: Optional[float] = None

    def kernel_seconds(self, match: Callable[[str], bool]) -> Optional[float]:
        """Device seconds of the ops whose name ``match``es; None where none
        ran."""
        ds = [d for n, _, d in self.kernels if match(n)]
        return sum(ds) / 1e6 if ds else None

    def span_seconds(self, *names: str) -> list:
        return [s.dur for s in self.spans if s.name in names]


def _merge(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce_trace(events, top: int = 10):
    """From the profiler's raw events (``kineto_results.events()``): the
    device ops [(name, start_us, dur_us)], the device's busy seconds (the
    union of their intervals), the ``breakdown``: the ops that took most
    device time and the longest idle gaps, each named by what the host was
    doing at its middle (the benchmark's outermost range and the innermost
    host op there)."""
    import numpy as np
    from torch.autograd import DeviceType
    kernels, host = [], []
    for e in events:
        start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            # the benchmark's own ranges mirrored on the device's timeline
            # are annotations, not device work
            if not (e.is_user_annotation() or e.name().startswith(ANNOTATION)):
                kernels.append((e.name(), start, dur))
        elif e.device_type() == DeviceType.CPU:
            host.append((start, start + dur, e.name()))
    busy = _merge((s, s + d) for _, s, d in kernels)
    busy_s = sum(b - a for a, b in busy) / 1e6
    by_name: dict = {}
    for n, _, d in kernels:
        by_name[n] = by_name.get(n, 0.0) + d / 1e6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:top]
    idle = []
    hs = np.array([h[0] for h in host])
    he = np.array([h[1] for h in host])
    for gap, a, b in gaps:
        mid = (a + b) / 2
        inside = np.flatnonzero((hs <= mid) & (he >= mid)) if host else []
        bench = [host[i] for i in inside if host[i][2].startswith(ANNOTATION)]
        inner_ops = [host[i] for i in inside
                     if not host[i][2].startswith(ANNOTATION)]
        outer = max(bench, key=lambda h: h[1] - h[0])[2] if bench \
            else "outside the benchmark's ranges"
        inner = min(inner_ops, key=lambda h: h[1] - h[0])[2] if inner_ops \
            else "Python"
        idle.append([f"{outer} > {inner}"[:160], gap / 1e6])
    breakdown = {"device_ops": [[n[:160], s] for n, s in top_ops],
                 "idle_gaps": idle}
    return kernels, busy_s, breakdown


# ---------------------------------------------------------------------------
# the host's load over a window
# ---------------------------------------------------------------------------


class HostLoad:
    """Over a window: its length and this process's CPU seconds. Where the
    two move together from run to run, the same work ran on a slower
    core; where the wall time grows alone, the process waited."""

    def __init__(self):
        self.t, self.cpu = time.perf_counter(), os.times()

    def read(self) -> dict:
        t, cpu = time.perf_counter(), os.times()
        own = (cpu.user + cpu.system) - (self.cpu.user + self.cpu.system)
        return {"window_s": t - self.t, "process_cpu_s": own}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def _device_info(device, chips: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             log=print, check_imports: bool = True) -> dict:
    """One run of ``cell``: set-up, the measured window (traced with
    ``trace``), the check against the reference. Returns the result
    object; raises ``BenchError`` where no result may be printed.
    ``check_imports=False`` skips the look for JAX in ``sys.modules``
    (for tests that run cells inside a process that holds it)."""
    stages = Stages(time.perf_counter() if t0 is None else t0)
    import torch
    import repro_torch  # noqa: F401  (the program under test)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise BenchError("CUDA is not available")
        if torch.cuda.device_count() < cell.chips:
            raise BenchError(f"the cell needs {cell.chips} cards, "
                             f"{torch.cuda.device_count()} found")
    stages.mark("imports")
    if dev.type == "cuda":
        from repro_torch.kernels._build import load_all
        built = load_all()
        log(json.dumps({"kernels_built": {
            k: b.build_s for k, b in built.items()}}), file=sys.stderr)
    stages.mark("kernels")

    driver = load_module("drivers", cell.traffic["driver"])
    state = driver.setup(cell, seed, dev, stages)
    _sync(dev)
    setup_s = stages.total()
    stages.mark("warmup_tail")
    log(json.dumps({"setup_stages": stages.seconds, "setup_s": setup_s}),
        file=sys.stderr)

    def untraced():
        load = HostLoad()
        win = driver.window(state, seconds)
        _sync(dev)
        host = load.read()
        log(json.dumps({"host": host}), file=sys.stderr)
        return win, host["window_s"]

    spans, kernels, busy_s, breakdown, traced_s = [], [], None, None, None
    win, plain, plain_s = None, None, None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.obs import trace as obs_trace
        # the host's clock reads the untraced window; the traced one
        # follows it at the same length
        plain, plain_s = untraced()
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with obs_trace.collect(max_spans=2_000_000) as tracer, \
                profile(activities=acts) as prof:
            t1 = time.perf_counter()
            win = driver.window(state, seconds)
            _sync(dev)
            traced_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        spans = list(tracer.spans)
        kernels, busy_s, breakdown = reduce_trace(
            prof.profiler.kineto_results.events())
        del prof
        log(json.dumps({"trace_read_s": time.perf_counter() - t2,
                        "device_ops": len(kernels)}), file=sys.stderr)
    else:
        win, _ = untraced()
    if check_imports:
        guard()
    device_info = _device_info(dev, cell.chips)

    metrics = {}
    if trace:
        ctx = TraceCtx(cell=cell, records=win.records, spans=spans,
                       kernels=kernels, busy_s=busy_s, window_s=traced_s,
                       plain=plain.records, plain_s=plain_s)
        for m in cell.per_layer:
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device_info.update(busy_s=busy_s, window_s=traced_s)
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in win.end_to_end:
                metrics[m["name"]] = {"value": float(win.end_to_end[m["name"]]),
                                      "unit": m["unit"]}

    driver.release(state)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check(state)
    if check_imports:
        guard()
    correct = bool(checks) and all(v <= lim for v, lim in checks.values())
    windows = [w for w in (plain, win) if w is not None]
    result = {"correct": correct,
              "attempted": sum(int(w.attempted) for w in windows),
              "failed": sum(int(w.failed) for w in windows),
              "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": float(v), "limit": float(lim)}
                        for k, (v, lim) in checks.items()}
    return result
