#!/usr/bin/env python3
"""Variants of the flash-attention kernel's wgmma and simt bodies, side by
side on one card: each is ``src/repro_torch/csrc/flash_attention.cu`` with
a few lines replaced, built by nvcc with the port's flags, held against
``attention_ref`` and timed (device time, the profiler) at the serving
shape, a long one, gemma3-12b's two prefill shapes at D = 256 (causal,
and with its window of 1024) and the training shape in f32 (the simt
body), beside ``F.scaled_dot_product_attention`` and, at D = 256, the
``mma`` body. ``--against FILE`` builds another source of the kernel (a
parent commit's, say) and times it in turns with the rest.

    python3 tools/flash_variants.py [--only NAME ...] [--shapes NAME ...]
                                    [--against FILE]

Needs one H100. Some variants break the function on purpose (they show
what a part of the body costs): their errors are printed, not checked.
Variants named ``mma_*`` change the ``mma`` body and run it at D > 128
only; ``simt_*`` change the ``simt`` body and run at the f32 shapes only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
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
EDGE = "edge[x] = edge_at(kt + 64 * x);"
MMA_KV = """      load_tile<DP>(Ks, k, a.kss, kt, M_BK, a.S, a.D, vec8);
      load_tile<DP>(Vs, v, a.vss, kt, M_BK, a.S, a.D, vec8);
"""
MMA_PV = """        mma_bf16(oacc[dt], pa, pack_raw(vp[0], vp[LD]),
                 pack_raw(vp[8 * LD], vp[9 * LD]));
"""
SIMT_EXP = "        sc[r][c] = ex2(sc[r][c] - mu);"
SIMT_QK = "for (int r = 0; r < TM; ++r) sc[r][c] = fmaf(qv[u][r], kv[u], sc[r][c]);"
SIMT_PV = """          acc[r][4 * i] = fmaf(pr[r], vv.x, acc[r][4 * i]);
          acc[r][4 * i + 1] = fmaf(pr[r], vv.y, acc[r][4 * i + 1]);
          acc[r][4 * i + 2] = fmaf(pr[r], vv.z, acc[r][4 * i + 2]);
          acc[r][4 * i + 3] = fmaf(pr[r], vv.w, acc[r][4 * i + 3]);
"""
SIMT_NO_QK = "for (int r = 0; r < TM; ++r) (void)0;"
SIMT_SHFL = "        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));\n"
SIMT_MASK = ("if (!live(a, q0 + TM * rg + r, kt + cg + CG * c)) "
             "sc[r][c] = -INFINITY;")
SIMT_COPY = [("      copy_v(it);\n", ""),
             ("      if (it + 1 < n_tiles) copy_k(it + 1);\n", "")]
SIMT_D64 = "using S64 = SCfg<64, 1, 4, 8, 64>;"
SIMT_QK_LOOP = "#pragma unroll 8\n    for (int d = 0; d < DP; d += 4) {"
SIMT_PV_LOOP = "#pragma unroll 8\n    for (int j = 0; j < BK; ++j) {"


def simt_tile(stages, tm, cg, bq):
    """The D <= 64 configuration with TM rows x CG lanes a row group and
    BQ rows a block (csrc SCfg)."""
    return [(SIMT_D64, f"using S64 = SCfg<64, {stages}, {tm}, {cg}, {bq}>;")]


VARIANTS = {
    "shipped": [],
    # exp2 without the subnormal fix-up that the non-flushing form costs
    "exp2_flush": [(EX2, EX2.replace("ex2.approx.f32", "ex2.approx.ftz.f32"))],
    # 64-row blocks, one warpgroup each (three blocks an SM)
    "rows_64": [("launch_wgmma<1, 2>(a, st)", "launch_wgmma<1, 1>(a, st)")],
    # masks on the whole of every edge tile, not only on the halves
    # that need them
    "mask_whole_tile": [(EDGE, "edge[x] = edge_at(kt) || edge_at(kt + BK - 64);")],
    # diagnostics (wrong results): no masks; no exp2 at all
    "no_mask": [("    if (any_edge) {", "    if (false) {")],
    "no_exp2": [(P_EXP, P_EXP.replace("ex2(fmaf", "(fmaf"))],
    # the mma body (D = 256) without its K/V tile loads (stale tiles), and
    # without its PV products
    "mma_no_kv_loads": [(MMA_KV, "")],
    "mma_no_pv": [(MMA_PV, "")],
    # the simt body at D <= 64 with two stages (two blocks an SM, not
    # three), and with other thread tiles: rows x lanes a row group, rows a
    # block, stages (4 x 16 x 64 at two stages: 256 threads, the first
    # design; 128 rows: four q-tiles a head at S = 512)
    "simt_two_stage": simt_tile(2, 4, 8, 64),
    "simt_4x16_64": simt_tile(2, 4, 16, 64),
    "simt_4x16_64_one_stage": simt_tile(1, 4, 16, 64),
    "simt_8x16_64_one_stage": simt_tile(1, 8, 16, 64),
    "simt_8x8_64_one_stage": simt_tile(1, 8, 8, 64),
    "simt_8x16_128_one_stage": simt_tile(1, 8, 16, 128),
    # D <= 128 at one stage (one block an SM either way)
    "simt_d128_one_stage": [("using S128 = SCfg<128, 2, 4, 16, 64>;",
                             "using S128 = SCfg<128, 1, 4, 16, 64>;")],
    # the products' loops unrolled 2 and 4 times (8 shipped), and in full
    "simt_unroll_2": [(SIMT_QK_LOOP, SIMT_QK_LOOP.replace("unroll 8",
                                                          "unroll 2")),
                      (SIMT_PV_LOOP, SIMT_PV_LOOP.replace("unroll 8",
                                                          "unroll 2"))],
    "simt_unroll_4": [(SIMT_QK_LOOP, SIMT_QK_LOOP.replace("unroll 8",
                                                          "unroll 4")),
                      (SIMT_PV_LOOP, SIMT_PV_LOOP.replace("unroll 8",
                                                          "unroll 4"))],
    "simt_unroll": [(SIMT_QK_LOOP, SIMT_QK_LOOP.replace("unroll 8", "unroll")),
                    (SIMT_PV_LOOP, SIMT_PV_LOOP.replace("unroll 8",
                                                        "unroll 16"))],
    # 4-byte copies everywhere (the unaligned views' path)
    "simt_4byte": [("int vec4 = aligned;", "int vec4 = 0;")],
    # simt diagnostics (wrong results): no exp2 of the scores; no softmax
    # reductions or exp2; no masks; no copies after the first tile; no
    # QK^T products; no PV products; neither product
    "simt_no_exp2": [(SIMT_EXP, SIMT_EXP.replace("ex2(", "("))],
    "simt_no_softmax": [(SIMT_EXP, SIMT_EXP.replace("ex2(", "(")),
                        (SIMT_SHFL, "        (void)0;\n")],
    "simt_no_mask": [(SIMT_MASK, ";")],
    "simt_no_copy": SIMT_COPY,
    "simt_no_qk": [(SIMT_QK, SIMT_NO_QK)],
    "simt_no_pv": [(SIMT_PV, "")],
    "simt_no_products": [(SIMT_QK, SIMT_NO_QK), (SIMT_PV, "")],
}
# (B, H, Hkv, S, D, window, dtype), causal; f32 runs the simt body
SHAPES = {"serve": (8, 32, 8, 512, 64, 0, "bfloat16"),
          "long": (4, 32, 8, 2048, 64, 0, "bfloat16"),
          "wide": (2, 16, 8, 1024, 256, 0, "bfloat16"),
          "local": (2, 16, 8, 2048, 256, 1024, "bfloat16"),
          "train": (8, 32, 8, 512, 64, 0, "float32"),
          "train_d128": (8, 32, 8, 512, 128, 0, "float32"),
          "wide_f32": (2, 16, 8, 1024, 256, 0, "float32")}


def body_for(name: str, shape) -> str | None:
    """The body a variant runs at a shape (None: not run there). A source
    given by --against runs mma at D > 128, where it may lack wgmma."""
    D, dtype = shape[4], shape[6]
    if dtype == "float32":
        return "simt" if not name.startswith("mma") else None
    if name.startswith("simt_"):
        return None
    if name == "mma" or name.startswith("mma_"):
        return "mma" if D > 128 else None
    return "mma" if name == "against" and D > 128 else "wgmma"

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
    entries = [i for i, ln in enumerate(log) if "Compiling entry" in ln
               and "flash_fwd" in ln]
    # "flash_fwd_wgmmaILi4ELi2E...": the body and its template arguments
    # ("flash_fwd_simt_sliced...": none)
    names = [(re.search(r"flash_fwd_\w+?EE", log[i])
              or re.search(r"flash_fwd_[a-z_]+", log[i])).group(0)
             for i in entries]
    ptxas = [name + ": " + ln.split("info    : ")[-1].strip()
             for i, name in zip(entries, names)
             for ln in log[i:i + 4] if "Used" in ln or "spill" in ln]
    ptxas += [ln for ln in log if "wgmma" in ln and "Performance" in ln]
    return fn, ptxas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=list(VARIANTS))
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES))
    ap.add_argument("--against", type=Path, default=None,
                    help="another flash_attention.cu (e.g. a parent "
                    "commit's), built and timed in turns as 'against'")
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
    jobs = {n: (VARIANTS[n], src) for n in VARIANTS if n in args.only}
    if args.against is not None:
        jobs["against"] = ([], args.against.read_text())
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip(jobs, ex.map(
            lambda n: build(n, jobs[n][0], jobs[n][1], out_dir), jobs)))
    for n, (_, ptxas) in built.items():
        print(json.dumps({"variant": n, "ptxas": ptxas}),
              flush=True)
    rng = np.random.default_rng(0)
    data = {k: chip_smoke._inputs(rng, *SHAPES[k][:5],
                                  getattr(torch, SHAPES[k][6]), "bshd")
            for k in args.shapes}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    wide = any(SHAPES[k][4] > 128 and SHAPES[k][6] == "bfloat16"
               for k in args.shapes)
    names = [*built, "sdpa", *(["mma"] if wide else [])]
    rows = {n: {} for n in names}
    for rep in range(2):                    # two rounds, variants in turn
        for name in names:
            fn = built[name][0] if name in built else built[next(iter(built))][0]
            binding._fn = lambda fn=fn: fn
            for shape, (q, k, v) in data.items():
                S, W = SHAPES[shape][3], SHAPES[shape][5]
                body = None if name == "sdpa" else body_for(name, SHAPES[shape])
                if name == "sdpa":
                    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                    pos = torch.arange(S, device="cuda")
                    mask = (pos[:, None] >= pos[None, :]) & \
                        (pos[:, None] - pos[None, :] < W) if W else None
                    call = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa: E731
                                        is_causal=not W, enable_gqa=True)
                elif body is None:
                    continue
                else:
                    call = lambda: attention(q, k, v, window=W,  # noqa: E731
                                             body=body)
                    if rep == 0:
                        ref = attention_ref(*(x.transpose(1, 2)
                                              for x in (q, k, v)), window=W)
                        err = (call().float() - ref.transpose(1, 2).float()) \
                            .abs().max().item()
                        rows[name][f"{shape}_max_abs_err"] = err
                        rows[name][f"{shape}_body"] = body
                rows[name].setdefault(f"{shape}_ms", []).append(
                    chip_smoke._device_ms_per_call(call))
    for name, row in rows.items():
        print(json.dumps({"variant": name, "card": smi, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
