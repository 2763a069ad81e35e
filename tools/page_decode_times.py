#!/usr/bin/env python3
"""Page decode of one row group on one card: the page-unpack kernel beside
its bound, its plain version and the NumPy decode it replaces.

    python3 tools/page_decode_times.py [--rows 2097152] [--reps 50] [--seed 7]

Writes the benchmark's ``ads-criteo`` table (``perfbench/configs``, its
generator and its LEVEL2 delete of 0.5% of the users) at ``--rows`` rows in
row groups of 2**19, then reads the ads scan's 22 columns on ``cuda`` once,
keeping the staging buffer of the first group's unpack launch (its
device-route pages, and the host-route pages of its BF16 columns as pages
of their codes). Then, on that one launch:

  kernel_ms   the launch replayed ``--reps`` times between CUDA events;
  bound_ms    the bytes it has to move (each page's packed codes, its
              dictionary and deleted rows read once, each value written once)
              at 3.35 TB/s;
  plain_ms    the plain version (``page_unpack_ref``) on the card's tensors,
              CUDA events around one call;
  numpy_ms    the host's NumPy decode of its device-route pages
              (``decode_page``, then ``apply_dv``), host clock;
  read_ms     the whole read of the table (``Dataset.to_table`` of the 22
              columns, dequantized), host clock, on ``cuda`` and with
              ``use_kernel=False`` (the NumPy route), medians of 5;
  pages_device, pages_host
              the counters ``bullion.decode.pages_device`` and
              ``bullion.decode.pages_host`` over one scan of each of the
              traffic file's predicates, as perfbench/drivers/scan.py scans;
  census      the top-level encodings of the scan's pages after the
              delete.

Prints one JSON line with the card's name and power limit. Needs one CUDA
card; run from the repository's root.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

HBM_BYTES_PER_S = 3.35e12


class _Stages:
    def mark(self, name):
        pass


def _card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": out}


def _events_ms(fn, reps: int) -> float:
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2**21)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    from perfbench.lib import tables
    from repro_torch.core import BullionReader
    from repro_torch.core import pages as pages_mod
    from repro_torch.core.encodings.base import blob_encoding_name
    from repro_torch.core.footer import PageType
    from repro_torch.dataset import dataset, page_route
    from repro_torch.kernels.page_unpack import page_unpack_ref
    from repro_torch.kernels.page_unpack.kernel import page_unpack_fwd
    from repro_torch.obs import metrics

    SCALAR = int(PageType.SCALAR)
    cfg = json.loads((ROOT / "perfbench/configs/ads-criteo.json").read_text())
    cfg["rows"] = args.rows
    traffic = json.loads((ROOT / "perfbench/traffic/scan-4pred.json")
                         .read_text())
    columns = traffic["columns"]
    table = tables.make(cfg, args.seed, "cuda", _Stages())
    try:
        seen, taken = [], []
        real_unpack, real_take = page_route.page_unpack, \
            page_route.DeviceDecode.take

        def unpack(staging, layout, out):
            seen.append((staging.clone(), layout, out, len(taken)))
            return real_unpack(staging, layout, out)

        def take(self, blob, page_rows, dtype, dv=None, align=False):
            page = real_take(self, blob, page_rows, dtype, dv, align)
            if page is not None:
                taken.append((blob, page_rows, dv, page))
            return page

        def read(use_kernel, where=None, parallelism=None):
            with dataset(table.path, device="cuda") as ds:
                ds = ds.select(columns)
                if where is not None:
                    ds = ds.where(where)
                return ds.dequantized(True)._with_kernel(use_kernel) \
                    .to_table(**({} if parallelism is None
                                 else {"parallelism": parallelism}))

        page_route.page_unpack, page_route.DeviceDecode.take = unpack, take
        read(None, parallelism=1)          # the groups' calls in turn
        page_route.page_unpack, page_route.DeviceDecode.take = \
            real_unpack, real_take
        staging, layout, out, n_taken = seen[0]
        taken = taken[:n_taken]
        need = layout.moved_bytes
        replay, plain = torch.zeros_like(out), torch.zeros_like(out)
        kernel_ms = _events_ms(lambda: page_unpack_fwd(
            staging, layout.n_pages, layout.n_blocks, replay), args.reps)
        plain_ms = _events_ms(lambda: page_unpack_ref(
            staging, layout.n_pages, plain), 1)
        t0 = time.perf_counter()
        for blob, page_rows, dv, _ in taken:
            pages_mod.apply_dv(pages_mod.decode_page(SCALAR, blob), dv,
                               page_rows)
        numpy_ms = (time.perf_counter() - t0) * 1e3
        read_ms = {}
        for name, use_kernel in (("cuda", None), ("numpy", False)):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                read(use_kernel)
                times.append((time.perf_counter() - t0) * 1e3)
            read_ms[name] = statistics.median(times)
        counters = [metrics.counter(f"bullion.decode.pages_{route}")
                    for route in ("device", "host")]
        before = [c.value for c in counters]
        for pred in traffic["predicates"]:
            read(None, tables.predicate(pred["where"]))
        pages_device, pages_host = (c.value - b
                                    for c, b in zip(counters, before))
        census = {}
        with BullionReader(table.path) as r:
            fv = r.footer
            ids = [p for name in columns for g in range(fv.n_groups)
                   for p in range(*fv.chunk_pages(g, fv.column_index(name)))]
            for blob in r._read_pages(ids).values():
                name = blob_encoding_name(blob)
                census[name] = census.get(name, 0) + 1
        print(json.dumps({
            **_card(), "rows": args.rows, "pages": layout.n_pages,
            "blocks": layout.n_blocks,
            "values_bytes": int((layout.desc["rows"]
                                 * layout.desc["out_size"]).sum()),
            "bytes": need, "kernel_ms": kernel_ms,
            "bound_ms": need / HBM_BYTES_PER_S * 1e3,
            "roofline_pct": 100.0 * need / HBM_BYTES_PER_S * 1e3 / kernel_ms,
            "plain_ms": plain_ms, "numpy_ms": numpy_ms, "read_ms": read_ms,
            "pages_device": pages_device, "pages_host": pages_host,
            "device_share": pages_device / (pages_device + pages_host),
            "census": census,
            "plain_equal": bool(torch.equal(replay, plain))}))
    finally:
        table.remove()


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
