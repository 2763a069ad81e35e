#!/usr/bin/env python3
"""Variants of the read path's two kernels, side by side on one card: the
column-list body of ``src/repro_torch/csrc/dequant.cu`` and the bit
transpose of ``src/repro_torch/csrc/bitunpack.cu``, each with a few lines
replaced, built by nvcc with the port's flags, checked bit for bit against
the plain version and timed (device time, the profiler; warm and cold in
L2) in turns.

    python3 tools/read_variants.py [--only NAME ...]

dequant runs at the ads scan's payload launch (12 BF16 columns of 2**20
rows) beside ``q.view(torch.bfloat16).float()``; bitunpack at 2**24 values
at widths 1, 4, 11 and 32. Needs one H100.
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

DQ_RUN = "for (int j = 0; j < F; ++j) run[j * 32 + lane] = mine[j * 32 + lane];"

DEQUANT = {
    "shipped": [],
    # one 16-byte vector a thread (4 KB tiles), or four (16 KB tiles)
    "vecs_1": [("constexpr int kVecs = 2;", "constexpr int kVecs = 1;")],
    "vecs_4": [("constexpr int kVecs = 2;", "constexpr int kVecs = 4;")],
    # stores that are evicted first from L2
    "streaming_stores": [(DQ_RUN, DQ_RUN.replace(
        "run[j * 32 + lane] = mine[j * 32 + lane];",
        "__stcs(run + j * 32 + lane, mine[j * 32 + lane]);"))],
}
DEQUANT_TILES = {"vecs_1": 4096, "vecs_4": 16384}

BU_16 = ("constexpr int kGroups = 8;", "constexpr int kGroups = 16;")
BU_ALL_SHUFFLED = ("kLaunch[local_stages(w)]", "kLaunch[0]")

BITUNPACK = {
    "shipped": [],
    # every stage a shuffle, whatever the width
    "all_shuffled": [BU_ALL_SHUFFLED],
    # bounds checks on every run
    "always_checked": [("if ((g0 + kGroups) * 32 <= n)", "if (false)")],
    "groups_4": [("constexpr int kGroups = 8;", "constexpr int kGroups = 4;")],
    "groups_16": [BU_16],
    "groups_16_all_shuffled": [BU_16, BU_ALL_SHUFFLED],
    # stores that are evicted first from L2
    "streaming_stores": [("dst[u * 32] = x[u];", "__stcs(dst + u * 32, x[u]);")],
}


def build(name, text, reps, out_dir, symbol):
    from repro_torch.kernels import _build
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
    log = (proc.stdout + proc.stderr).splitlines()
    ptxas = [ln.split("info    : ")[-1].strip()
             for i, ln in enumerate(log) if "Compiling entry" in ln
             and symbol in ln for ln in log[i:i + 4]
             if "Used" in ln or "spill" in ln]
    return ctypes.CDLL(str(so)), ptxas


def dequant_rows(names, libs, flush):
    from repro_torch.core.quantization import QuantMode, QuantSpec, quantize
    from repro_torch.kernels.dequant import staging as staging_mod
    from repro_torch.kernels.dequant.ref import dequant_packed_ref
    N, cols = 2**20, 12
    bits = quantize(np.random.default_rng(0).normal(size=(cols, N))
                    .astype(np.float32), QuantSpec(QuantMode.BF16))
    q = torch.from_numpy(bits).cuda()
    shipped_tile = staging_mod.TILE_BYTES
    runs = {}
    for name in names:
        staging_mod.TILE_BYTES = DEQUANT_TILES.get(name, shipped_tile)
        packed = staging_mod.pack_columns(list(bits), [(0.0, 0.0)] * cols)
        staging_mod.TILE_BYTES = shipped_tile
        dev = packed.buffer.cuda()
        out = torch.empty(packed.n_out, dtype=torch.float32, device="cuda")
        fn = libs[name].dequant_columns_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p]

        def call(fn=fn, dev=dev, out=out, packed=packed):
            err = fn(dev.data_ptr(), cols, packed.n_tiles, out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            assert err == 0, err

        out.fill_(7.0)
        call()
        want = dequant_packed_ref(dev, cols, packed.n_out)
        same = torch.equal(out.view(torch.int32), want.view(torch.int32))
        runs[name] = (call, same)
    runs["library"] = (lambda: q.view(torch.bfloat16).float(), True)
    rows = {n: {"bit_exact": same} for n, (_, same) in runs.items()}
    for _ in range(2):                      # two rounds, variants in turn
        for name, (call, _) in runs.items():
            warm, cold = chip_smoke._warm_cold_ms(call, flush)
            rows[name].setdefault("warm_ms", []).append(warm)
            rows[name].setdefault("cold_ms", []).append(cold)
    return rows


def bitunpack_rows(names, libs, flush):
    from repro_torch.kernels.bitunpack import bitunpack_ref
    n = 2**24
    rng = np.random.default_rng(1)
    rows = {name: {} for name in names}
    for w in (1, 4, 11, 32):
        planes = torch.from_numpy(rng.integers(0, 2**32, (n // 32, w),
                                               dtype=np.uint64)
                                  .astype(np.uint32)).cuda()
        want = bitunpack_ref(planes, w).view(torch.int32)
        out = torch.empty(n, dtype=torch.uint32, device="cuda")
        for name in names:
            fn = libs[name].bitunpack_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_void_p]

            def call(fn=fn, planes=planes, w=w, out=out):
                err = fn(planes.data_ptr(), w, 1, w, n, out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            out.zero_()
            call()
            rows[name][f"w{w}_bit_exact"] = torch.equal(out.view(torch.int32),
                                                        want)
            for _ in range(2):
                warm, cold = chip_smoke._warm_cold_ms(call, flush)
                rows[name].setdefault(f"w{w}_warm_ms", []).append(warm)
                rows[name].setdefault(f"w{w}_cold_ms", []).append(cold)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*",
                    default=[*(f"dequant:{n}" for n in DEQUANT),
                             *(f"bitunpack:{n}" for n in BITUNPACK)])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("read_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out_dir = Path(tempfile.mkdtemp(prefix="read_variants_"))
    jobs = []
    for kernel, variants, symbol in (("dequant", DEQUANT, "dequant_columns"),
                                     ("bitunpack", BITUNPACK, "bitunpack")):
        text = (ROOT / f"src/repro_torch/csrc/{kernel}.cu").read_text()
        jobs += [(kernel, name, text, reps, symbol)
                 for name, reps in variants.items()
                 if f"{kernel}:{name}" in args.only]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda j: build(f"{j[0]}_{j[1]}", j[2], j[3],
                                            out_dir, j[4]), jobs))
    libs = {(k, n): lib for (k, n, *_), (lib, _) in zip(jobs, built)}
    for (k, n, *_), (_, ptxas) in zip(jobs, built):
        print(json.dumps({"kernel": k, "variant": n, "ptxas": ptxas}),
              flush=True)
    flush = torch.empty(2**27, dtype=torch.uint8, device="cuda")
    for kernel, rows_of in (("dequant", dequant_rows),
                            ("bitunpack", bitunpack_rows)):
        names = [n for k, n in libs if k == kernel]
        if not names:
            continue
        rows = rows_of(names, {n: libs[(kernel, n)] for n in names}, flush)
        for name, row in rows.items():
            print(json.dumps({"kernel": kernel, "variant": name, "card": smi,
                              **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
