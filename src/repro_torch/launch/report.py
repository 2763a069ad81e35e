"""Render the roofline table from the port's dry-run artifacts, ported
from ``repro.launch.report``: the same table, read from
artifacts/dryrun_torch/ (``launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.report [--mesh 16x16] [--tag baseline]
  PYTHONPATH=src python -m repro_torch.launch.report --both-meshes
"""

from __future__ import annotations

import argparse
import glob
import json
import os

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

ARCH_ORDER = ["whisper-base", "rwkv6-7b", "llama3.2-1b", "gemma3-12b",
              "minicpm3-4b", "starcoder2-15b", "mixtral-8x22b",
              "deepseek-moe-16b", "recurrentgemma-9b", "chameleon-34b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def canon(name: str) -> str:
    return name.replace(".", "-").replace("_", "-")


def load(mesh: str, tag: str = "") -> dict:
    recs = {}
    suffix = f"__{tag}.json" if tag else ".json"
    for path in glob.glob(os.path.join(ARTIFACT_DIR, f"*__{mesh}{suffix}")):
        base = os.path.basename(path)
        if not tag and base.count("__") != 2:
            continue  # skip tagged artifacts in the untagged view
        with open(path) as f:
            r = json.load(f)
        recs[(canon(r.get("arch", "")), r["shape"])] = r
    return recs


def _fmt(v, digits=3):
    if v is None:
        return "-"
    if v == 0:
        return "0"
    return f"{v:.{digits}g}"


def table(mesh: str = "16x16", tag: str = "") -> str:
    recs = load(mesh, tag)
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "6ND/HLO | roofline frac | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((canon(arch), shape))
            if r is None:
                lines.append(f"| {arch} | {shape} | - | - | - | - | - | - | missing |")
                continue
            if r["status"] == "skipped":
                lines.append(f"| {arch} | {shape} | - | - | - | - | - | - | "
                             f"SKIP: full-attention family |")
                continue
            if r["status"] != "ok":
                lines.append(f"| {arch} | {shape} | - | - | - | - | - | - | "
                             f"ERROR {r.get('error', '')[:60]} |")
                continue
            t = r["roofline"]
            lines.append(
                f"| {arch} | {shape} | {_fmt(t['compute_s'])} | "
                f"{_fmt(t['memory_s'])} | {_fmt(t['collective_s'])} | "
                f"{t['dominant']} | {_fmt(r.get('useful_flops_ratio'))} | "
                f"{_fmt(t['roofline_frac'], 2)} | |")
    return "\n".join(lines)


def _terms(r) -> str:
    if r is None:
        return "missing"
    if r["status"] == "skipped":
        return "SKIP"
    if r["status"] != "ok":
        return "ERROR"
    t = r["roofline"]
    return (f"{_fmt(t['compute_s'])} / {_fmt(t['memory_s'])} / "
            f"{_fmt(t['collective_s'])} {t['dominant']}")


def side_by_side(tag: str = "") -> str:
    """Both production meshes' roofline terms in one table, a row a cell:
    compute / memory / collective seconds and the dominant term, as
    ``table`` renders them for each mesh; the cells skipped on both are
    named after the table."""
    recs = {m: load(m, tag) for m in ("16x16", "2x16x16")}
    lines = ["| arch | shape | 16x16: compute / memory / collective s | "
             "2x16x16: compute / memory / collective s |",
             "|---|---|---|---|"]
    skipped = []
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            cells = [_terms(recs[m].get((canon(arch), shape)))
                     for m in ("16x16", "2x16x16")]
            if cells == ["SKIP", "SKIP"]:
                skipped.append(f"{arch} {shape}")
                continue
            lines.append(f"| {arch} | {shape} | {cells[0]} | {cells[1]} |")
    if skipped:
        lines += ["", "SKIP (full-attention family): " + ", ".join(skipped)]
    return "\n".join(lines)


def cell_detail(arch: str, shape: str, mesh: str = "16x16", tag: str = "") -> dict:
    recs = load(mesh, tag)
    key = (canon(arch), shape)
    if key not in recs:
        raise KeyError((arch, shape, mesh, tag))
    return recs[key]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--tag", default="")
    ap.add_argument("--both-meshes", action="store_true",
                    help="both production meshes side by side")
    args = ap.parse_args()
    print(side_by_side(args.tag) if args.both_meshes
          else table(args.mesh, args.tag))


if __name__ == "__main__":
    main()
