#!/usr/bin/env python3
"""Where the column-list dequant's copies should land, measured on one card.

    python3 tools/dequant_staging.py [--reps N]

Times the steps of ``kernels.dequant.dequant_columns`` (pack the codes into
a staging buffer, copy it to the card, launch the column-list body, copy
the values back, synchronise) at the read path's two launch shapes of the
ads scan: 4 and 12 BF16 columns of 2**20 rows. Four ways to stage, in turns
within one process:

  pageable          pack into pageable memory, copy back into a fresh
                    pageable array
  pinned_in         pack into page-locked memory, copy back into a fresh
                    pageable array
  pinned_in_out     page-locked both ways, the columns handed back as views
                    of the page-locked output (what the package ships)
  pinned_out_copied page-locked both ways, then the values copied into a
                    fresh array (no page-locked memory outlives the call)
  pinned_in_out_torch_pack
                    pinned_in_out with the codes packed by PyTorch's
                    ``copy_`` (which may split a large copy over threads)
                    instead of NumPy's ``copyto``

Prints one JSON line per (shape, way): host ms of the whole call (median),
of the packing, and the copies' device ms and GB/s from CUDA events. Then
the packing's host copy alone, NumPy ``copyto`` against PyTorch's
``copy_`` (which may split a large copy over threads), into one
page-locked buffer; and the host time of ``torch.empty(...,
pin_memory=True)`` at the staging and output sizes, freed between calls
(does the caching allocator hand the block back?). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.quantization import (QuantMode, QuantSpec,  # noqa: E402
                                           quantize)
from repro_torch.kernels.dequant import dequant_packed, pack_columns  # noqa: E402

WAYS = ("pageable", "pinned_in", "pinned_in_out", "pinned_out_copied",
        "pinned_in_out_torch_pack")


def torch_pack(codes, params, *, pin):
    """``pack_columns`` with its copies made by ``torch.Tensor.copy_``."""
    real = np.copyto

    def copyto(dst, src):
        if src.flags.writeable and all(st >= 0 for st in src.strides):
            torch.from_numpy(dst).copy_(torch.from_numpy(src))
        else:
            real(dst, src)

    np.copyto = copyto
    try:
        return pack_columns(codes, params, pin=pin)
    finally:
        np.copyto = real


def run(codes, way: str) -> tuple[list, dict]:
    """One call of the column list staged `way`; returns the columns and
    the times of its steps."""
    t0 = time.perf_counter()
    pack = torch_pack if way.endswith("torch_pack") else pack_columns
    packed = pack(codes, [(0.0, 0.0)] * len(codes), pin=way != "pageable")
    t1 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    staging = packed.buffer.to("cuda", non_blocking=True)
    ev[1].record()
    out = dequant_packed(staging, packed.n_cols, packed.n_tiles, packed.n_out)
    ev[2].record()
    pinned_out = way.startswith(("pinned_in_out", "pinned_out"))
    host = torch.empty(packed.n_out, dtype=torch.float32,
                       pin_memory=pinned_out)
    host.copy_(out, non_blocking=True)
    ev[3].record()
    torch.cuda.current_stream().synchronize()
    if way == "pinned_out_copied":
        host = torch.from_numpy(host.numpy().copy())
    cols = [host[o:o + r] for o, r in zip(packed.out_offsets, packed.rows)]
    t2 = time.perf_counter()
    return cols, dict(host_ms=(t2 - t0) * 1e3, pack_ms=(t1 - t0) * 1e3,
                      h2d_ms=ev[0].elapsed_time(ev[1]),
                      kernel_ms=ev[1].elapsed_time(ev[2]),
                      d2h_ms=ev[2].elapsed_time(ev[3]),
                      h2d_bytes=packed.buffer.numel(),
                      d2h_bytes=4 * packed.n_out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dequant_staging: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(0)
    N = 2**20
    bits = quantize(rng.normal(size=(12, N)).astype(np.float32),
                    QuantSpec(QuantMode.BF16))
    want = (bits.astype(np.uint32) << 16)
    for cols in (4, 12):
        codes = list(bits[:cols])
        for way in WAYS:                                  # warm-up, check
            got, _ = run(codes, way)
            assert all(np.array_equal(g.numpy().view(np.uint32), w)
                       for g, w in zip(got, want[:cols])), way
        samples = {way: [] for way in WAYS}
        for _ in range(args.reps):                        # in turns
            for way in WAYS:
                samples[way].append(run(codes, way)[1])
        for way in WAYS:
            med = {k: float(np.median([s[k] for s in samples[way]]))
                   for k in samples[way][0]}
            print(json.dumps(dict(
                columns=cols, rows=N, way=way, reps=args.reps, **med,
                h2d_gb_per_s=med["h2d_bytes"] / med["h2d_ms"] / 1e6,
                d2h_gb_per_s=med["d2h_bytes"] / med["d2h_ms"] / 1e6,
                device=torch.cuda.get_device_name(0), nvidia_smi=smi)),
                flush=True)
    dst = torch.empty(bits.nbytes, dtype=torch.uint8, pin_memory=True)
    host = dst.numpy()
    for how in ("numpy_copyto", "torch_copy_") * 2:
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for i, col in enumerate(bits):
                part = host[i * col.nbytes:(i + 1) * col.nbytes].view(col.dtype)
                if how == "numpy_copyto":
                    np.copyto(part, col)
                else:
                    torch.from_numpy(part).copy_(torch.from_numpy(col))
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        print(json.dumps(dict(pack_copy=how, columns=len(bits), rows=N,
                              bytes=bits.nbytes, host_ms=ms,
                              gb_per_s=bits.nbytes / ms / 1e6,
                              threads=torch.get_num_threads(),
                              nvidia_smi=smi)), flush=True)
    del dst, host
    for nbytes in (bits.nbytes + 12 * 64, 4 * bits.size) * 2:
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            buf[::4096].fill_(1)                  # touch every page
            times.append(time.perf_counter() - t0)
            del buf
        print(json.dumps(dict(pinned_alloc_bytes=nbytes,
                              first_ms=times[0] * 1e3,
                              median_ms=float(np.median(times)) * 1e3,
                              nvidia_smi=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
