"""The port's trace export (``obs/export.py``), Prometheus exposition
(``obs/expose.py``), ``Dataset.profile`` and ``BULLION_TRACE`` on the CPU,
held against the JAX package's ``repro.obs``.

Tolerance: none. The same span records and the same metrics snapshot give
the same documents and the same text in both packages. Spans of a real scan
carry times, so there the names, counts and arguments are compared.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.core as ref_core
import repro.dataset as ref_dataset
import repro.obs as ref_obs
import repro_torch.core as core
import repro_torch.obs as obs
from repro_torch.dataset import dataset
from repro_torch.obs import export, expose, trace
from repro_torch.scan import C

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")


def _write(pkg, path, *, n=1000, rows_per_group=100):
    rng = np.random.default_rng(0)
    w = pkg.BullionWriter(path, [pkg.ColumnSpec("id", "int64"),
                                 pkg.ColumnSpec("score", "float32")],
                          rows_per_group=rows_per_group)
    w.write_table({"id": np.arange(n, dtype=np.int64),
                   "score": rng.random(n).astype(np.float32)})
    w.close()
    return path


@pytest.fixture(autouse=True)
def _isolate_tracers():
    """Save and restore both packages' process-wide tracer slots."""
    prev, ref_prev = trace.current(), ref_obs.trace.current()
    yield
    trace.install(prev)
    ref_obs.trace.install(ref_prev)


def _records(pkg_trace):
    """The same finished spans, as each package's SpanRecord: two threads,
    nested spans, NumPy and odd argument values, a fractional scalar."""
    rows = [("exec.task", "exec", 0.0, 2e-3, 11, "scan-0",
             {"group": np.int64(3), "rows": 100}),
            ("decode.pread", "io", 1e-4, 5e-4, 11, "scan-0",
             {"bytes": np.uint32(4096), "pages": 2}),
            ("decode.decode", "decode", 7e-4, 9e-4, 12, "scan-1",
             {"column": "score", "f": np.float32(0.25), "h": np.float64(1.5),
              "o": (1, 2)}),
            ("exec.filter", "exec", 1.7e-3, 1e-4, 12, "scan-1",
             {"route": "kernel", "x": np.float32(0.1), "none": None})]
    return [pkg_trace.SpanRecord(*r) for r in rows]


@pytest.mark.parametrize("dropped,trace_id", [(0, None), (3, "abc123")])
def test_chrome_trace_equals_reference(dropped, trace_id):
    got = export.chrome_trace(_records(trace), pid=7, dropped=dropped,
                              trace_id=trace_id)
    want = ref_obs.export.chrome_trace(_records(ref_obs.trace), pid=7,
                                       dropped=dropped, trace_id=trace_id)
    assert got == want
    assert json.loads(json.dumps(got)) == got


def test_profile_and_write_trace_equal_reference(tmp_path):
    prof = export.Profile.from_spans(_records(trace), dropped=1,
                                     trace_id="t-1")
    ref = ref_obs.export.Profile.from_spans(_records(ref_obs.trace),
                                            dropped=1, trace_id="t-1")
    assert prof.chrome["traceEvents"][1:] == ref.chrome["traceEvents"][1:]
    assert repr(prof) == repr(ref)
    got_agg, want_agg = prof.aggregate(), ref.aggregate()
    assert sorted(got_agg) == sorted(want_agg)
    for k in got_agg:
        assert (got_agg[k].count, got_agg[k].seconds) == \
            (want_agg[k].count, want_agg[k].seconds)
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    assert prof.write(a) == a
    ref_obs.export.write_trace(b, _records(ref_obs.trace), dropped=1,
                               trace_id="t-1")
    assert json.load(open(a)) == json.load(open(b))
    assert sorted(os.listdir(tmp_path)) == ["a.json", "b.json"]  # no .tmp


def _snapshot():
    return {
        "bullion.io.preads": 12,
        "bullion.io.bytes": 1 << 40,
        "bullion.flag": True,
        "bullion.ratio": 0.125,
        "9lives.odd-name": 3,
        "bullion.decode.seconds": {"count": 5, "sum": 0.0123, "p50": 0.002,
                                   "p99": 0.004},
        "bullion.loader.queue_depth": {"count": 0, "sum": 0.0, "p50": None,
                                       "p99": None},
    }


def test_prometheus_text_equals_reference_and_parses_back():
    snap = _snapshot()
    text = expose.prometheus_text(snap)
    assert text == ref_obs.expose.prometheus_text(snap)
    assert text.endswith("\n")
    parsed = expose.parse_prometheus_text(text)
    assert parsed.keys() == ref_obs.expose.parse_prometheus_text(text).keys()
    assert parsed["bullion_io_preads"] == 12
    assert parsed["bullion_flag"] == 1
    assert parsed['bullion_decode_seconds{quantile="0.99"}'] == 0.004
    assert parsed["bullion_decode_seconds_count"] == 5
    assert np.isnan(parsed['bullion_loader_queue_depth{quantile="0.5"}'])
    assert parsed["_9lives_odd_name"] == 3
    assert expose.prometheus_text({}) == ref_obs.expose.prometheus_text({})


@pytest.mark.parametrize("name", ["bullion.io.preads", "a-b c", "", "0x",
                                  "ok_name:sub"])
def test_sanitize_name_equals_reference(name):
    assert expose.sanitize_name(name) == ref_obs.expose.sanitize_name(name)


@pytest.mark.parametrize("bad", ["metric value extra", "bad{x=1} 3",
                                 "{} 1", "name"])
def test_parser_rejects_malformed_like_reference(bad):
    with pytest.raises(ValueError):
        expose.parse_prometheus_text(bad)
    with pytest.raises(ValueError):
        ref_obs.expose.parse_prometheus_text(bad)


def test_registry_snapshot_round_trips(tmp_path):
    """The port's own registry after a traced read renders and parses back
    to its snapshot's values."""
    path = _write(core, str(tmp_path / "t.bln"))
    with trace.collect():
        with dataset(path, device="cpu") as ds:
            ds.where(C("score") > 0.5).to_table()
    snap = obs.metrics.snapshot()
    parsed = obs.parse_prometheus_text(obs.prometheus_text(snap))
    for name, v in snap.items():
        pname = expose.sanitize_name(name)
        if isinstance(v, dict):
            assert parsed[f"{pname}_count"] == v["count"]
        else:
            assert parsed[pname] == float(v)


def _profile_summary(prof):
    """What a profile of one plan holds, times left out: span names and
    counts, and the arguments of the plan's tasks."""
    counts = {}
    for s in prof.spans:
        counts[s.name] = counts.get(s.name, 0) + 1
    tasks = sorted((s.args.get("shard"), s.args.get("group"))
                   for s in prof.spans if s.name == "exec.task")
    return counts, tasks


@pytest.mark.parametrize("parallelism,io_depth", [(1, 1), (2, 2)])
def test_dataset_profile_matches_reference(tmp_path, parallelism, io_depth):
    path = _write(core, str(tmp_path / "t.bln"))
    ref_path = _write(ref_core, str(tmp_path / "r.bln"))
    out = str(tmp_path / "trace.json")
    ds = dataset(path, device="cpu").select(["id"]).where(C("score") > 0.25)
    prof = ds.profile(out, parallelism=parallelism, io_depth=io_depth)
    ds.close()
    from repro.scan import C as RC
    with ref_dataset.dataset(ref_path).select(["id"]).where(
            RC("score") > 0.25) as rds:
        ref = rds.profile(parallelism=parallelism, io_depth=io_depth)
    assert prof.dropped == ref.dropped == 0
    got, want = _profile_summary(prof), _profile_summary(ref)
    assert got == want
    assert {"exec.task", "decode.pread", "decode.decode",
            "exec.filter"} <= set(got[0])
    doc = json.load(open(out))
    x = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(x) == len(prof.spans)
    named = {e["tid"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {e["tid"] for e in x} <= named


def test_bullion_trace_env_writes_at_exit(tmp_path):
    """BULLION_TRACE=path on a fresh interpreter writes the port's Chrome
    trace at exit, covering a real scan on the CPU."""
    path = _write(core, str(tmp_path / "t.bln"))
    out = str(tmp_path / "env-trace.json")
    code = ("from repro_torch.dataset import dataset\n"
            f"ds = dataset({path!r}, device='cpu')\n"
            "ds.to_table(io_depth=2)\n"
            "ds.close()\n")
    env = dict(os.environ, BULLION_TRACE=out,
               PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH",
                                                               "")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, timeout=120,
                          capture_output=True, text=True, check=True)
    assert "BULLION_TRACE export" not in proc.stderr
    doc = json.load(open(out))
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"plan.optimize", "plan.lower", "exec.task"} <= names
