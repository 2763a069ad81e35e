#!/usr/bin/env python3
"""Variants of the flash-attention kernel's wgmma body, side by side on one
card: each is ``src/repro_torch/csrc/flash_attention.cu`` with a few lines
replaced, built by nvcc with the port's flags, held against
``attention_ref`` and timed (device time, the profiler) at the serving
shape and a long one, beside ``F.scaled_dot_product_attention``.

    python3 tools/flash_variants.py [--only NAME ...]

Needs one H100. Some variants break the function on purpose (they show
what a part of the body costs): their errors are printed, not checked.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

EX2 = '  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));'
P_EXP = """      const float p0 = ex2(fmaf(s[i], a.scale_log2, -mu[r]));
      const float p1 = ex2(fmaf(s[i + 1], a.scale_log2, -mu[r]));"""
EDGE1 = "edge1 = edge_at(kt + 64);"

VARIANTS = {
    "shipped": [],
    # exp2 without the subnormal fix-up that the non-flushing form costs
    "exp2_flush": [(EX2, EX2.replace("ex2.approx.f32", "ex2.approx.ftz.f32"))],
    # 64-row blocks, one warpgroup each (three blocks an SM)
    "rows_64": [("launch_wgmma<1, 2>(a, st)", "launch_wgmma<1, 1>(a, st)")],
    # masks on the whole of every edge tile, not only on the halves
    # that need them
    "mask_whole_tile": [(EDGE1, "edge1 = edge0 || edge_at(kt + 64);"),
                        ("const bool edge0 = edge_at(kt),",
                         "const bool edge0 = edge_at(kt) || edge_at(kt + 64),")],
    # diagnostics (wrong results): no masks; no exp2 at all
    "no_mask": [("    if (edge0 || edge1) {", "    if (false) {")],
    "no_exp2": [(P_EXP, P_EXP.replace("ex2(fmaf", "(fmaf"))],
}
SHAPES = {"serve": (8, 32, 8, 512, 64), "long": (4, 32, 8, 2048, 64)}


def build(name, reps, src, out_dir):
    from repro_torch.kernels import _build
    text = src
    for old, new in reps:
        if old not in text:
            raise RuntimeError(f"variant {name}: text not found: {old[:60]}")
        text = text.replace(old, new)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    fn = ctypes.CDLL(str(so)).flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 22 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    log = (proc.stdout + proc.stderr).splitlines()
    wg = [i for i, ln in enumerate(log) if "Compiling entry" in ln
          and "flash_fwd_wgmma" in ln]
    ptxas = [ln.split("info    : ")[-1].strip() for i in wg
             for ln in log[i:i + 4] if "Used" in ln or "spill" in ln]
    ptxas += [ln for ln in log if "wgmma" in ln and "Performance" in ln]
    return fn, ptxas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs a CUDA card")
    import repro_torch.kernels.flash_attention.kernel as binding
    from repro_torch.kernels.flash_attention import attention, attention_ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    out_dir = Path(tempfile.mkdtemp(prefix="flash_variants_"))
    names = [n for n in VARIANTS if n in args.only]
    with ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(
            lambda n: build(n, VARIANTS[n], src, out_dir), names)))
    fns = {n: fn for n, (fn, _) in built.items()}
    for n, (_, ptxas) in built.items():
        print(json.dumps({"variant": n, "ptxas_wgmma_bodies": ptxas}),
              flush=True)
    rng = np.random.default_rng(0)
    data = {k: chip_smoke._inputs(rng, B, H, Hkv, S, D, torch.bfloat16, "bshd")
            for k, (B, H, Hkv, S, D) in SHAPES.items()}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {n: {} for n in [*names, "sdpa"]}
    for rep in range(2):                    # two rounds, variants in turn
        for name in [*names, "sdpa"]:
            if name != "sdpa":
                binding._fn = lambda fn=fns[name]: fn
            for shape, (q, k, v) in data.items():
                if name == "sdpa":
                    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                    call = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa: E731
                                        enable_gqa=True)
                else:
                    call = lambda: attention(q, k, v, body="wgmma")  # noqa: E731
                    if rep == 0:
                        ref = attention_ref(*(x.transpose(1, 2)
                                              for x in (q, k, v)))
                        err = (call().float() - ref.transpose(1, 2).float()) \
                            .abs().max().item()
                        rows[name][f"{shape}_max_abs_err"] = err
                rows[name].setdefault(f"{shape}_ms", []).append(
                    chip_smoke._device_ms_per_call(call))
    for name, row in rows.items():
        print(json.dumps({"variant": name, "card": smi, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
