"""The manifest (``BENCHMARK.json``) against the benchmark's rules, the
discovery of cells by name, and the guard against JAX."""

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.lib import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"][:2] == ["python3", "perfbench/run.py"]
    assert manifest["paths"] == ["perfbench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(manifest):
    names = [c["name"] for c in manifest["configs"]]
    names += [w["name"] for w in manifest["workloads"]]
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w[k] for w in manifest["workloads"] for k in ("config", "traffic")]
    names += [k for c in manifest["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for group in (manifest["configs"], manifest["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_layer_metric_has_its_end_to_end_metric(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for w in manifest["workloads"]:
        cell = harness.find_cell(manifest, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert m["moves"] in reported, (w["name"], m["name"])


def test_cells_and_configs(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        harness.load_json("traffic", w["traffic"])
        harness.load_json("limits", w["name"])
    files = set()
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in cfg
            assert not key.endswith(("_dim", "_rank", "_size")), key
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


def test_readers_and_drivers_exist(manifest):
    for m in manifest["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    for w in manifest["workloads"]:
        driver = harness.load_json("traffic", w["traffic"])["driver"]
        mod = harness.load_module("drivers", driver)
        for fn in ("setup", "window", "release", "check"):
            assert callable(getattr(mod, fn))


def test_run_seconds_fits_a_full_check(manifest):
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_banned_modules_compare_whole_names():
    names = ["repro_torch", "repro_torch.models", "reprox", "jaxtyping",
             "numpy", "perfbench.lib"]
    assert harness.banned_modules(names) == []
    assert harness.banned_modules(names + ["jax.numpy", "repro.core",
                                           "flax"]) == ["flax", "jax", "repro"]


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """The command prints no result and exits 2 where CUDA is absent, and
    where the checkout holds only the manifest and ``perfbench/``."""
    run = [sys.executable, "perfbench/run.py", "--workload", "ads-scan",
           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"]
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        p = subprocess.run(run, cwd=cwd, capture_output=True, text=True,
                           env=env, timeout=300)
        assert p.returncode == 2, p.stderr[-2000:]
        assert p.stdout.strip() == ""


def test_a_new_cell_runs_from_new_files_alone(tmp_path):
    """A throwaway cell, with a configuration, a traffic mix, a limits file
    and a per-layer metric of its own, added to a copy as new files and a
    manifest entry, runs through the unchanged harness (on the CPU, small),
    and the whole run imports neither JAX nor the JAX package."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs/ads-criteo.json").read_text())
    cfg.update(name="ads-tiny", rows=2**13, rows_per_group=2**11)
    (pb / "configs/ads-tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic/scan-4pred.json").read_text())
    tr["predicates"] = tr["predicates"][:2]
    tr["warmup"] = [0]
    (pb / "traffic/scan-2pred.json").write_text(json.dumps(tr))
    (pb / "limits/tiny-scan.json").write_text("{}")
    (pb / "metrics/scan.count.py").write_text(
        "def read(ctx):\n    return len(ctx.records.get('scans', ())) or None\n")
    man["configs"].append({"name": "ads-tiny", "source": "test",
                           "file": "perfbench/configs/ads-tiny.json",
                           "reduced": ["rows"], "why": "test"})
    man["workloads"].append({"name": "tiny-scan", "config": "ads-tiny",
                             "traffic": "scan-2pred", "chips": 1,
                             "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] == "scan_rows_per_s":
            m["workloads"].append("tiny-scan")
    man["per_layer"].append({"name": "scan.count", "unit": "scans",
                             "better": "higher", "source": "host_clock",
                             "layer": "test", "moves": "scan_rows_per_s",
                             "workloads": ["tiny-scan"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT / 'src')!r}]\n"
        "from perfbench.lib import harness\n"
        "assert str(harness.ROOT) == sys.path[0]\n"
        "cell = harness.find_cell(harness.load_manifest(), 'tiny-scan')\n"
        "out = {}\n"
        "for trace in (False, True):\n"
        "    r = harness.run_cell(cell, seed=2**32 + 3, seconds=0.5,\n"
        "                         trace=trace, device='cpu',\n"
        "                         log=lambda *a, **k: None)\n"
        "    out[trace] = r\n"
        "print(json.dumps([out[False], out[True]]))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                            "TMPDIR": str(tmp_path)})
    assert p.returncode == 0, p.stderr[-3000:]
    plain, traced = json.loads(p.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"scan_rows_per_s", "setup_s"}
    assert traced["metrics"]["scan.count"]["value"] >= 1
    assert list(traced)[-1] == "checks"
    assert math.isfinite(plain["metrics"]["scan_rows_per_s"]["value"])
