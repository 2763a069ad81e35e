#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Drives the port's four main paths. Serving: full-width llama3.2-1b
(random weights from the seed, bf16) served by ``ServeEngine``: 8 prompts of
512 tokens, a prefill and 32 greedy decode steps, with prefill attention in
the hand-written flash-attention kernel; then the other block families
the same way at full width (gemma3-12b, deepseek-moe-16b, starcoder2-15b,
minicpm3-4b (MLA), recurrentgemma-9b (RG-LRU), rwkv6-7b (RWKV-6) and
whisper-base (encoder-decoder, over 1500 frames a clip) at full depth,
mixtral-8x22b on 2 layers), with windowed, MLA and the encoder's
non-causal prefill attention in the same kernel. The predicate read:
``dataset(p, device="cuda").select(...).where(...).to_table()`` over a 4 Mi-row
ads table, the LM corpus and a 4 Mi-row table of quantized columns, written
by the port's writer, with the dequantize of BF16 and affine-integer columns
in the hand-written dequant kernel (its column-list body: one launch for
the columns of each decode call) and the range filter in the hand-written
filter kernel. The BP32 unpack: ``pack_bp32`` then ``bitunpack`` of 2**24
values at width 11, in the hand-written unpack kernel. Deletion compliance
(``delete_where`` on copies of the 4 Mi-row ads table), the write sink
(``Dataset.write_to`` of the ads query), the training-data loader
(``BullionLoader`` over an LM corpus of 8 Mi tokens) and trace export, each
through the same filter and dequant kernels. The dataset service:
``DatasetServer(device="cuda")`` serving the ads table over a socket to 4
client sessions (range queries, projections and point probes), its
filter and dequantize in the same kernels. Training: ``make_train_step``
on full-width, full-depth llama3.2-1b at f32 (B=8, S=512) from a Bullion
corpus through ``BullionLoader``, every attention forward (and its
recompute under rematerialisation) in the flash kernel under autograd.
The distributed path: the same step through ``build(cfg,
dist=make_dist(mesh))`` on a (1, 1) ("data", "model") DeviceMesh over NCCL,
DTensor parameters placed by the port's sharding rules, the flash kernel
launched on each rank's local shards under ``local_map``; and serving the
same way: the serving model built with ``dist=make_dist(mesh)`` through
``ServeEngine``, its caches DTensors placed by ``cache_specs``. The launch
analysis: ``python -m repro_torch.launch.dryrun`` on fake 16x16 and
2x16x16 groups.
Phases, one JSON line each:

  1. device         -- CUDA, compute capability 9.x, the card's name and
                       power limit
  2. build          -- nvcc builds every csrc/*.cu for sm_90a, all at once
  3. kernels        -- flash attention against its plain version, 53 cases
                       (the training shape at f32 among them), each
                       through "auto" and through every body that
                       takes it (wgmma, mma for bf16; simt for f32); 19
                       of them with 128 < D <= 256, where "auto" takes
                       wgmma for aligned bf16 with D % 8 == 0, mma for
                       the other bf16 calls and simt for f32; 4 with
                       D = 320 and 512 (mma, simt: slices of 256 output
                       columns); 7 more f32 ones for the simt body's
                       configurations and copies (ragged S, S < 64, D =
                       1, 100, 128, 200 and 256, the window, kv_len, the
                       model's views and unaligned views); the last 9 at
                       the prefill shapes of phase families (gemma3-12b's
                       with and without its window, MLA_CASE: minicpm3-4b
                       at D = 96, RG_LOCAL: recurrentgemma-9b's local
                       layer, MQA at D = 256 with window 2048,
                       whisper-base's decoder prompt and WHISPER_ENC: its
                       encoder, not causal, S = 1500, bound 2e-2 x
                       max|ref| + 1e-3, which dropping its last 28 keys
                       must exceed), and WHISPER_DEC: its decoder at the
                       prompt plus 8 positions
  4. filter_kernels -- the range filter against its plain version, bit for
                       bit: C in {1,2,4,8} x N in {1, 2047, 2049, 1000003,
                       2**22} x three kinds of bounds, and strided views
  5. dequant_kernels   -- the dequant kernel against its plain version on
                          the card and NumPy on the CPU, bit for bit: the
                          [R, C] body on every code type x float32/float64
                          arithmetic x float32/bfloat16 output x four
                          shapes, and every code of the four storage types
                          through the read path's float64 route against
                          ``dequantize``; the column-list body on mixed
                          groups of the four code types (odd lengths, an
                          empty column, 70 columns) and on columns laid out
                          at unaligned offsets
  6. bitunpack_kernels -- the BP32 entry point once, with its launch count;
                          then the unpack kernel (a warp bit transpose)
                          against its plain version on the card and NumPy on
                          the CPU, exactly: widths 1-32 x n in {1, 31, 32,
                          8192, 8416, 2**24}, on contiguous and strided
                          planes
  7. serve          -- the serving path, its launch count (16 of the wgmma
                       body, none of the others), and the kernel against
                       its plain version on the q, k, v of each of the 16
                       layers
  8. profile        -- device time by kernel over one prefill and 8 decode
                       steps
  9. logits         -- at full width and one layer: prefill logits through
                       the kernel vs the plain version, decode vs a fresh
                       prefill
 10. times          -- flash attention at the serving shape: the wgmma and
                       mma bodies and the PyTorch library call in device
                       time, warm and cold in L2, against the bound (bytes,
                       products, and exp2 at the MUFU rate) and the plain
                       version; the event time of back-to-back calls; the
                       wgmma body at a gemma3-12b prefill (D = 256) the
                       same way, with the mma body's times beside it; the
                       mma and simt bodies at D = 512
 11. window_times   -- the wgmma body at a gemma3-12b local layer's prefill
                       (B=2, S=2048, 16/8 heads of 256, window 1024) warm
                       and cold, against the bound of the window's live
                       pairs, its plain version and SDPA with the
                       equivalent boolean mask; the mma body's times
                       beside it
 12. family_times   -- the wgmma body at MLA_CASE (the padded call) beside
                       SDPA with V at 64 unpadded, with the padded and
                       the unpadded work's bounds; at RG_LOCAL beside SDPA
                       with the boolean mask; at WHISPER_ENC beside SDPA
                       unmasked and the mma body; warm and cold; then
                       decode_attention: the decode-attention kernel at
                       the generate cells' shapes mid-decode
                       (DECODE_CASES, bf16 q over the f32 cache) against
                       its plain version (the path it replaced: the cache
                       cast to q's dtype, dot_attention), warm and cold,
                       beside its bytes bound, the plain version and SDPA
                       (the yardstick)
 13. families       -- the block families served at full width through
                       ServeEngine in bf16: gemma3-12b (48 layers, B=2,
                       prompt 2048, 32 new tokens: 48 flash launches a
                       prefill, all wgmma, 40 with window=1024),
                       deepseek-moe-16b (28 layers, B=8, prompt 512: 28
                       wgmma), starcoder2-15b (40 layers, B=8, prompt
                       512), mixtral-8x22b (2 of its 56 layers, B=8,
                       prompt 512), minicpm3-4b (62 layers, B=8, prompt
                       512: 62 wgmma at D = 96), recurrentgemma-9b (38
                       layers, B=2, prompt 4096: 12 wgmma with window
                       2048, none in the 26 RG-LRU layers) and rwkv6-7b
                       (32 layers, B=8, prompt 512: no launch), the last
                       twice: the loop over time, then rwkv_chunked, and
                       whisper-base (6 + 6 layers, B=16 clips of 1500
                       frames, prompt 64, max_seq 448: 12 wgmma, 6 not
                       causal, by launches_by_causal); each
                       family's prefill and decode times, bounds, peak
                       memory, a profiled prefill and 4 decode steps
                       (flash share, expert products' device ms, pairs
                       dropped by capacity, finite logits: required,
                       but of rwkv_chunked, which must stay non-finite
                       from the chunked WKV's f32 overflow), host seconds;
                       then family_logits at full width and one pattern
                       repeat: gemma3-12b at 6 layers with a prompt of
                       1100 (past its window), deepseek-moe-16b at 2
                       layers (dense + MoE, capacity for every pair),
                       minicpm3-4b at 1, recurrentgemma-9b at 3 with a
                       prompt of 2100 (at f32) and rwkv6-7b at 1: prefill
                       through the kernel vs the plain version with f32
                       probabilities, greedy decode vs a fresh prefill;
                       recurrentgemma-9b's local layer alone at bf16, on
                       its attention output, the same two checks;
                       rwkv6-7b's chunked WKV vs the loop over time;
                       whisper-base at one encoder and one decoder layer
                       over 1500 frames: its logits at f32, and at bf16
                       every flash launch of the prompt's and 8 fresh
                       prefills' on its own inputs and each decode step's
                       self-attention against the kernel's (its
                       logits_witness line beside them), and the served
                       model's depth_witness line
 14. filter_times   -- the range filter at C=4, N=2**20 against its bound
                       and its plain version
 15. dequant_times  -- the column-list body at the ads payload's launch
                       shape (12 BF16 columns of 2**20 rows) and on one
                       column, the [R, C] body on one column, the
                       bench_quantization probe and an INT16 column, against
                       the bound, the plain version and, for bf16 bits, the
                       PyTorch call
 16. bitunpack_times -- the unpack kernel at 2**24 values, widths 1, 4, 11
                        and 32
 17. scan           -- the read path: launch counts per scan (the filter once
                       a row group evaluated, the column-list dequant once a
                       decode call with a BF16 or affine column, the page
                       unpack once a decode call that routes a page or has
                       such a column), results equal to the NumPy route,
                       serially and on 4 threads, scan times, and the time
                       split (host stages, device copies and kernels); then
                       page_unpack: the benchmark's ads-criteo table at one
                       row group of 2**19 rows, its LEVEL2 delete applied,
                       read on the card (one unpack and one dequant launch,
                       equal to the NumPy route), and that read's unpack
                       staging replayed through the wrapper against
                       page_unpack_ref on the card, bit for bit: kernel_ms,
                       bound_ms (its bytes at 3.35 TB/s), plain_ms, and the
                       host's NumPy decode of the same pages
 18. service        -- DatasetServer(device="cuda") on the ads table, 4
                       socket sessions x 25 queries (range, projection,
                       probes): launches equal to the queries' alone,
                       replies equal to a device="cpu" server's,
                       queries/s, p50 and p99; the CLI's fsck --json on
                       the table (exit 0) and a flipped copy (exit 1),
                       metrics --socket
 19. compliance     -- delete_where on copies of the ads table (a float32
                       range over two dense features at L2 and L1, 16 users
                       at L2): files byte-identical to the device="cpu"
                       route's, the audit, the rows left, the launches,
                       the I/O ratio and the host time of each delete
 20. sink           -- write_to of the ads query, dequantized, sorted by
                       dense_0, in shards of 2**19 rows: shards
                       byte-identical to the cpu route's, read back equal to
                       the scan sorted, the launches; the sink of an L1
                       deleted copy leaves no raw occurrence
 21. loader         -- BullionLoader(predicate=) as rank 0 and 1 of 2 against
                       the cpu loader, a mid-epoch resume, the filter's
                       launches with the loader's thread and a main-thread
                       scan reading at once, tokens per second;
                       quality_filtered_read against its cpu route
 22. export         -- Dataset.profile(path) of the ads query, BULLION_TRACE
                       in a fresh interpreter, Prometheus text round trip
 23. train          -- 8 f32 steps: step_ms each, the median of steps 2-8,
                       train_tokens_per_s beside the bound, peak memory,
                       flash launches (2 x 16 a step, all simt), finite
                       losses; one step traced by kernel (GEMMs, flash
                       forward, the plain attention backward, AdamW); at
                       full width and one layer, loss and gradients through
                       the kernel against attention_ref under autograd
                       (3e-5), and the loss of one repeated batch falling
                       (at full depth the random init's gradient norm is
                       near 1e11 and the loss does not move past its noise:
                       printed, with the norm at 1, 2, 4, 8 layers); 2 steps
                       at bf16 compute (all wgmma); the launcher at --smoke
                       to step 6, then resumed to 8; a restored step equal
                       to the uninterrupted one
 24. distributed    -- NCCL at world size 1, the port's (1, 1) mesh:
                       full-width, full-depth llama3.2-1b at f32 on phase
                       train's first batch, sharded (DTensor parameters),
                       3 steps: step_ms, the median of steps 2-3, peak
                       memory, flash launches (32 a step, all simt, on
                       local shards under local_map), one more step
                       traced by kernel (busy share); the loss and every
                       parameter after one step against the unsharded
                       step (2e-4; one layer held where depth amplifies
                       rounding past it, the full-depth gap printed);
                       the sharded parameters saved and restored by
                       elastic_restore into another model (bit-equal,
                       placed by spec_tree) and one more step of each;
                       deepseek-moe-16b at full width and 2 layers, the
                       sharded MoE path's loss against the local path's
                       (2e-3); rwkv6-7b at full width and one layer, the
                       sharded loss against the unsharded (1e-5 relative)
 25. sharded_serve  -- NCCL at world size 1 again, the (1, 1) mesh:
                       full-width, full-depth llama3.2-1b at bf16 built
                       with dist=make_dist(mesh) (DTensor parameters, the
                       caches DTensors placed by cache_specs) served by
                       ServeEngine as in phase serve: prefill_ms and decode
                       ms a step beside phase serve's, 16 wgmma flash
                       launches a prefill (under local_map), the 32 tokens
                       equal to phase serve's; prefill and 4 decode steps
                       against the unsharded model (logits within phase
                       serve's bound, every cache tensor's gap); the real
                       sharded prefill counted by launch.hlo_cost (kernel
                       launched) equal in FLOPs to the same shapes on fake
                       tensors (dryrun.serve_count, a subprocess), its
                       roofline bound beside _serve_bounds'; then one
                       pattern of deepseek-moe-16b (2 layers), minicpm3-4b
                       (1), recurrentgemma-9b (3, f32), rwkv6-7b (1) and
                       whisper-base (1 + 1, f32) sharded against unsharded
 26. dryrun         -- python -m repro_torch.launch.dryrun in subprocesses
                       (fake groups of 256 and 512 ranks, fake tensors):
                       llama3.2-1b on every shape on 16x16, decode_32k on
                       2x16x16, deepseek-moe-16b and whisper-base
                       prefill_32k on 16x16; each record ok, n_devices
                       right, bound_s > 0; launch.report's tables
 27. train_times    -- flash attention at the training shape (f32, simt)
                       against its bound, its plain version and SDPA, warm
                       and cold; the plain backward's device time

then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failed check raises, and the script exits non-zero without the
last line. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from io import StringIO
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense: HBM3 rate and bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12          # outside the tensor cores
F64_FLOP_PER_S = 34e12          # outside the tensor cores

SERVE_B, SERVE_P, SERVE_NEW, SERVE_MAX_SEQ = 8, 512, 32, 1024
TOL = {torch.bfloat16: 3e-2, torch.float32: 3e-5}   # tests/test_kernels.py


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def median_ms(fn, samples: int = 25, per_sample: int = 10) -> float:
    """Device time of one call of fn: the median over `samples` of CUDA-event
    time around `per_sample` back-to-back calls, divided by `per_sample`
    (back to back, so the host's launch cost hides behind the device)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return float(np.median(times))


def _launch_counters() -> dict:
    """Each wrapper's launch count; the dequant kernel has two bodies, each
    with its wrapper: ``dequant`` ([R, C]) and ``dequant_packed`` (the
    column list the read path launches)."""
    from repro_torch.kernels.bitunpack import bitunpack
    from repro_torch.kernels.dequant import dequant, dequant_packed
    from repro_torch.kernels.filter import range_mask
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.page_unpack import page_unpack
    return {"flash_attention": flash_attention, "range_mask": range_mask,
            "dequant": dequant, "dequant_packed": dequant_packed,
            "bitunpack": bitunpack, "page_unpack": page_unpack}


def zero_counts() -> None:
    """Every kernel's launch count to 0 (flash attention's by body too),
    just before a main path runs."""
    for fn in _launch_counters().values():
        fn.launches = 0
    from repro_torch.kernels.flash_attention import flash_attention
    for body in flash_attention.launches_by_body:
        flash_attention.launches_by_body[body] = 0
    flash_attention.launches_by_window.clear()
    flash_attention.launches_by_causal.clear()


def counts() -> dict:
    return {name: fn.launches for name, fn in _launch_counters().items()}


def decode_kernel_calls() -> int:
    """Layer calls of the decode-attention kernel so far, a replayed
    step's among them (the counter ``bullion.attn.decode_kernel_calls``;
    the wrapper's own ``launches`` counts the calls made from the host, a
    captured step once). Each call is two or three kernels."""
    from repro_torch.obs import metrics
    return metrics.counter("bullion.attn.decode_kernel_calls").value


def cache_attending(cfg) -> int:
    """Layers whose decode step runs the decode-attention kernel: the
    blocks of ``ATTN_KINDS`` (an encoder-decoder's segments are its decoder
    layers), not MLA's (its own latent cache) nor the recurrent ones."""
    from repro_torch.models.transformer import ATTN_KINDS
    return sum(rep * sum(b.split(":")[0] in ATTN_KINDS for b in blocks)
               for blocks, rep in cfg.segments)


@contextlib.contextmanager
def decode_calls():
    """While open, tallies the read path's ``decode_group`` calls on the
    card, from any thread (``page_route.DeviceDecode.launch``): ``routed``,
    the calls in which a page took the device route, ``pages`` their
    pages, and ``unpack``, the calls that launch the page-unpack kernel
    once each: those that route a page or have a column for the dequant
    kernel."""
    import threading

    from repro_torch import resolve_device
    from repro_torch.dataset import page_route
    real = page_route.DeviceDecode.launch
    tally = {"routed": 0, "pages": 0, "unpack": 0}
    lock = threading.Lock()

    def launch(self, columns):
        if resolve_device(self.device).type == "cuda":
            dq = any(col.params is not None for col in columns)
            with lock:
                tally["routed"] += self.taken > 0
                tally["pages"] += self.taken
                tally["unpack"] += self.taken > 0 or dq
        return real(self, columns)

    page_route.DeviceDecode.launch = launch
    try:
        yield tally
    finally:
        page_route.DeviceDecode.launch = real


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs on an H100")
    major, minor = torch.cuda.get_device_capability(0)
    check(major == 9, f"compute capability {major}.{minor}, need 9.x (Hopper)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, capability=f"{major}.{minor}", nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return kind


def phase_build() -> None:
    """Every kernel source, one nvcc each, started together."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.load_all()
    for name, b in built.items():
        regs = [ln.split("info    : ")[-1] for ln in b.log.splitlines()
                if "registers" in ln or "spill" in ln or "wgmma" in ln
                or "Compiling entry function" in ln]
        emit("build", source=f"src/repro_torch/csrc/{name}.cu",
             build_s=b.build_s, ptxas=regs)
    emit("build", all_s=time.perf_counter() - t0)


def _inputs(rng, B, H, Hkv, S, D, dtype, layout):
    """N(0,1) q, k, v from numpy; layout "bshd" (the model's), "bhsd",
    "fused": [B, S, heads, D] views of one [B, S, (H + 2 Hkv) D] projection,
    the strided layout a fused qkv weight gives the model, or "offset":
    [B, S, heads, D] views one element past an aligned base with a head
    stride of D + 1 (no 16-byte copies)."""
    if layout == "offset":
        return [torch.tensor(rng.normal(size=(B, S, n, D + 1)), dtype=dtype,
                             device="cuda")[..., 1:] for n in (H, Hkv, Hkv)]
    if layout == "fused":
        qkv = torch.tensor(rng.normal(size=(B, S, (H + 2 * Hkv) * D)),
                           dtype=dtype, device="cuda")
        return [qkv[..., :H * D].unflatten(-1, (H, D)),
                qkv[..., H * D:(H + Hkv) * D].unflatten(-1, (Hkv, D)),
                qkv[..., (H + Hkv) * D:].unflatten(-1, (Hkv, D))]
    shapes = [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)]
    out = [torch.tensor(rng.normal(size=s), dtype=dtype, device="cuda")
           for s in shapes]
    return out if layout == "bshd" else [x.transpose(1, 2).contiguous()
                                         for x in out]


SERVE_CASE = dict(B=SERVE_B, H=32, Hkv=8, S=SERVE_P, D=64,
                  dtype=torch.bfloat16, causal=True, window=0, kv_len=None,
                  layout="bshd")
# the training step's attention: llama3.2-1b at B=8, S=512, f32 (simt)
TRAIN_CASE = dict(SERVE_CASE, dtype=torch.float32)
# a gemma3-12b prefill (head_dim 256, 16 query and 8 kv heads) of 2 x 1024
WIDE_CASE = dict(B=2, H=16, Hkv=8, S=1024, D=256, dtype=torch.bfloat16,
                 causal=True, window=0, kv_len=None, layout="bshd")

# phase families: each model at full width, served at bf16 (B, prompt P,
# `new` greedy tokens, `max_seq` cache positions); `layers` cuts the depth
# where the whole model does not fit one card (mixtral-8x22b: 281 GB);
# `overrides` are config fields set for the run (rwkv6-7b's chunked WKV
# beside the configured loop over time)
FAMILY_RUNS = (
    dict(arch="gemma3_12b", B=2, P=2048, new=32, max_seq=2080),
    dict(arch="deepseek_moe_16b", B=8, P=512, new=32, max_seq=1024),
    dict(arch="starcoder2_15b", B=8, P=512, new=32, max_seq=1024),
    dict(arch="mixtral_8x22b", B=8, P=512, new=32, max_seq=1024, layers=2),
    dict(arch="minicpm3_4b", B=8, P=512, new=32, max_seq=1024),
    dict(arch="recurrentgemma_9b", B=2, P=4096, new=32, max_seq=4128),
    dict(arch="rwkv6_7b", B=8, P=512, new=32, max_seq=1024),
    dict(arch="rwkv6_7b", B=8, P=512, new=32, max_seq=1024,
         overrides=dict(rwkv_chunked=True)),
    # 16 clips of 30 s (the encoder's 1500 frames, from the seed), a prompt
    # of 64 tokens; max_seq is the decoder's context; `depth_witness`: print
    # what rounding does to the full-depth logits (its checks hold one layer)
    dict(arch="whisper_base", B=16, P=64, new=32, max_seq=448,
         depth_witness=True),
)
# the kernel at MLA's prefill shape (minicpm3-4b: 40 heads, qk dim 64 + 32,
# V padded from 64 to 96) and at recurrentgemma-9b's local layers (MQA,
# head_dim 256, a prompt of twice the window)
MLA_CASE = dict(B=8, H=40, Hkv=40, S=512, D=96, dtype=torch.bfloat16,
                causal=True, window=0, kv_len=None, layout="bshd")
MLA_DV = 64
RG_LOCAL = dict(B=2, H=16, Hkv=1, S=4096, D=256, window=2048)
# whisper-base's encoder attention: 16 clips of 1500 frames, 8 heads of 64,
# not causal; S is not a multiple of the 64-key tile
WHISPER_ENC = dict(B=16, H=8, Hkv=8, S=1500, D=64, dtype=torch.bfloat16,
                   causal=False, window=0, kv_len=None, layout="bshd")
# its keys past WHISPER_DROP: a kernel that skipped them would be off by
# the bound or more (phase kernels' fault witness)
WHISPER_DROP = 28
# whisper-base's decoder, causal at the prompt plus 8 decode positions:
# past a multiple of 64 keys (phase families' fresh prefills at P + i)
WHISPER_DEC = dict(B=2, H=8, Hkv=8, S=72, D=64, dtype=torch.bfloat16,
                   causal=True, window=0, kv_len=None, layout="bshd")


def _family_label(run) -> str:
    return run["arch"] + "".join(f"_{k}" for k, v in
                                 run.get("overrides", {}).items() if v)


def _family_cfg(run):
    import repro_torch.configs as configs
    cfg = configs.get(run["arch"]).scaled(compute_dtype="bfloat16",
                                          **run.get("overrides", {}))
    if run.get("layers"):
        (blocks, _), = cfg.segments
        cfg = cfg.scaled(segments=((blocks, run["layers"] // len(blocks)),))
    return cfg


def _windows(cfg) -> dict:
    """{window the flash kernel is given: layers} of a prefill: one launch
    for each layer that attends (full, global, window, local, mla; an
    encoder-decoder's encoder layers, with no window), none for the
    recurrent ones (rglru, rwkv)."""
    from repro_torch.models.transformer import ATTENDING, WINDOWED
    out: dict = {}
    for blocks, rep in cfg.segments:
        for b in blocks:
            kind = b.split(":")[0]
            if kind in ATTENDING:
                w = cfg.window if kind in WINDOWED else 0
                out[w] = out.get(w, 0) + rep
    if cfg.encoder is not None:
        out[0] = out.get(0, 0) + cfg.encoder.n_layers
    return out


def _causal(cfg) -> dict:
    """{causal flag the flash kernel is given: layers} of a prefill: the
    encoder's layers attend in both directions, every other one causally."""
    n_enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    n_causal = sum(_windows(cfg).values()) - n_enc
    return {flag: n for flag, n in ((True, n_causal), (False, n_enc)) if n}


def _attn_dim(cfg) -> int:
    """The head dim the flash kernel is given: MLA's qk dim (nope + rope;
    V is padded up to it), else head_dim."""
    if cfg.mla is not None:
        return cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
    return cfg.head_dim


def kernel_cases() -> list[dict]:
    base = dict(B=1, H=2, Hkv=2, causal=True, window=0, kv_len=None,
                layout="bhsd")
    cases = [dict(SERVE_CASE), dict(TRAIN_CASE)]
    for dtype in (torch.float32, torch.bfloat16):
        cases += [
            dict(base, S=384, D=128, dtype=dtype),
            dict(base, S=200, D=64, dtype=dtype),               # ragged S
            dict(base, B=2, H=4, Hkv=4, S=256, D=64, dtype=dtype, window=64),
            dict(base, B=2, H=4, Hkv=4, S=256, D=64, dtype=dtype, causal=False),
            dict(base, B=2, H=4, Hkv=1, S=256, D=64, dtype=dtype, kv_len=200),
            dict(base, B=2, H=8, Hkv=2, S=256, D=100, dtype=dtype,
                 causal=False, kv_len=100),         # H/Hkv = 4, D % 8 != 0
        ]
    cases.append(dict(base, B=2, H=4, Hkv=4, S=256, D=64,
                      dtype=torch.bfloat16, layout="bshd"))     # Hkv = H
    cases.append(dict(base, B=2, H=8, Hkv=2, S=384, D=128,
                      dtype=torch.bfloat16, layout="bshd"))     # D = 128, GQA
    cases.append(dict(base, B=1, H=4, Hkv=1, S=200, D=128,
                      dtype=torch.bfloat16, layout="bshd"))     # ragged S
    # 128 < D <= 256 (gemma3-12b, recurrentgemma-9b): wgmma and mma for
    # bf16, simt f32
    for dtype in (torch.float32, torch.bfloat16):
        cases += [
            dict(WIDE_CASE, dtype=dtype),           # gemma3-12b prefill, GQA
            dict(base, B=1, H=4, Hkv=1, S=1000, D=256, dtype=dtype,
                 layout="bshd"),                    # MQA, ragged S
            dict(base, B=2, H=4, Hkv=2, S=512, D=256, dtype=dtype,
                 window=128),                       # window, strided views
            dict(base, B=2, H=4, Hkv=4, S=384, D=256, dtype=dtype,
                 causal=False, kv_len=300),         # kv_len < S
        ]
    cases.append(dict(base, B=1, H=4, Hkv=2, S=300, D=200,
                      dtype=torch.bfloat16, layout="bshd"))     # D % 16 != 0
    bf16 = torch.bfloat16
    cases += [
        dict(base, B=2, H=8, Hkv=2, S=384, D=192, dtype=bf16,
             layout="bshd"),                        # D = 192, GQA 4:1
        dict(base, B=2, H=4, Hkv=4, S=512, D=192, dtype=bf16, window=128,
             layout="fused"),                       # window, the model's views
        dict(base, B=1, H=4, Hkv=1, S=300, D=200, dtype=bf16, kv_len=250,
             layout="bshd"),                        # MQA, kv_len < S
        dict(base, B=2, H=4, Hkv=2, S=384, D=200, dtype=bf16, causal=False,
             layout="bhsd"),                        # not causal, strided
        dict(base, B=2, H=16, Hkv=8, S=1100, D=256, dtype=bf16, window=1024,
             layout="fused"),                       # gemma3-12b's local layer
        dict(base, B=1, H=4, Hkv=1, S=1000, D=256, dtype=bf16, causal=False,
             kv_len=700, layout="fused"),           # MQA, kv_len < S
    ]
    # D > 256 (no configuration has one; the reference pads D to a multiple
    # of 128): mma for bf16, simt f32, a block a slice of 256 columns
    for dtype in (torch.float32, torch.bfloat16):
        cases += [
            dict(base, B=1, H=4, Hkv=2, S=300, D=320, dtype=dtype,
                 window=128, layout="bshd"),        # window, GQA
            dict(base, B=2, H=4, Hkv=1, S=256, D=512, dtype=dtype,
                 kv_len=200),                       # MQA, kv_len, strided
        ]
    # the f32 body's configurations and copy paths: ragged S, S < 64, odd D,
    # the window, kv_len, the model's views and views with no 16-byte copy
    f32 = torch.float32
    cases += [
        dict(base, B=1, H=4, Hkv=1, S=1000, D=64, dtype=f32,
             layout="bshd"),                        # ragged S, MQA
        dict(base, B=2, H=4, Hkv=2, S=40, D=64, dtype=f32),   # S < 64
        dict(base, B=1, H=2, Hkv=2, S=150, D=1, dtype=f32,
             layout="bshd"),                        # D = 1
        dict(base, B=2, H=8, Hkv=2, S=300, D=100, dtype=f32, window=96,
             layout="offset"),                      # D = 100, unaligned
        dict(base, B=1, H=4, Hkv=2, S=500, D=128, dtype=f32, kv_len=333,
             layout="fused"),                       # D = 128, kv_len
        dict(base, B=2, H=4, Hkv=1, S=384, D=256, dtype=f32, window=100,
             layout="offset"),                      # D = 256, unaligned
        dict(base, B=1, H=4, Hkv=4, S=333, D=200, dtype=f32, causal=False,
             layout="fused"),                       # D = 200, not causal
    ]
    # the prefill shapes of phase families, bf16 on the model's layout
    # (MLA_CASE among them), each once
    for run in FAMILY_RUNS:
        cfg = _family_cfg(run)
        for window in sorted(_windows(cfg)):
            case = dict(B=run["B"], H=cfg.n_heads, Hkv=cfg.n_kv_heads,
                        S=run["P"], D=_attn_dim(cfg), dtype=torch.bfloat16,
                        causal=True, window=window, kv_len=None,
                        layout="bshd")
            if case not in cases:
                cases.append(case)
        if cfg.encoder is not None:
            cases.append(dict(B=run["B"], H=cfg.n_heads, Hkv=cfg.n_heads,
                              S=cfg.encoder.seq, D=cfg.head_dim,
                              dtype=torch.bfloat16, causal=False, window=0,
                              kv_len=None, layout="bshd"))
    cases.append(dict(WHISPER_DEC))
    check(MLA_CASE in cases and _rg_local_case() in cases
          and WHISPER_ENC in cases,
          "kernel cases: no case at MLA_CASE, RG_LOCAL or WHISPER_ENC")
    return cases


def _rg_local_case() -> dict:
    return dict(B=RG_LOCAL["B"], H=RG_LOCAL["H"], Hkv=RG_LOCAL["Hkv"],
                S=RG_LOCAL["S"], D=RG_LOCAL["D"], dtype=torch.bfloat16,
                causal=True, window=RG_LOCAL["window"], kv_len=None,
                layout="bshd")


def _bodies(q, k, v) -> tuple[str, list]:
    """The body "auto" takes for these [B, S, H, D] inputs (and a fresh
    contiguous output), and every body that takes them."""
    from repro_torch.kernels.flash_attention.kernel import (BODIES,
                                                            select_body, takes)
    B, S, H, D = q.shape
    out_strides = [S * H * D, H * D, D]    # torch.empty: 512-byte aligned
    strides = [st for x in (q, k, v) for st in x.stride()[:3]] + out_strides
    ptrs = [x.data_ptr() for x in (q, k, v)] + [0]
    return (select_body(q.dtype, D, strides, ptrs),
            [b for b in BODIES if takes(b, q.dtype, D, strides, ptrs)])


def _want_body(dtype, D: int) -> str:
    """The body "auto" must take for a kernel case (every case's layout
    meets TMA's rules): wgmma for bf16 with D % 8 == 0 up to 256, mma for
    the other bf16 calls, simt for f32."""
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if D % 8 == 0 and D <= 256 else "mma"


def phase_kernels(seed: int) -> tuple[float, dict, float, dict, dict]:
    """The kernel vs attention_ref on the card, each case through "auto"
    and through every body that takes it; returns the wgmma body's error
    at the serving shape, the wgmma and mma bodies' at WIDE_CASE, the simt
    body's at TRAIN_CASE, the wgmma and mma bodies' at GEMMA_LOCAL, and the
    wgmma and mma bodies' at MLA_CASE ("mla"), RG_LOCAL ("rg_local") and
    WHISPER_ENC ("whisper_enc")."""
    from repro_torch.kernels.flash_attention import (attention, attention_ref,
                                                     flash_attention)
    serve_err = train_err = None
    wide_err, window_err = {}, {}
    family_err: dict = {"mla": {}, "rg_local": {}, "whisper_enc": {}}
    for i, c in enumerate(kernel_cases()):
        rng = np.random.default_rng(seed + i)
        q, k, v = _inputs(rng, c["B"], c["H"], c["Hkv"], c["S"], c["D"],
                          c["dtype"], c["layout"])
        kw = dict(causal=c["causal"], window=c["window"], kv_len=c["kv_len"])
        if c["layout"] in ("bshd", "fused", "offset"):
            ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), **kw)
            qs, ks, vs = q, k, v
        else:
            ref = attention_ref(q, k, v, **kw)
            qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        auto_body, bodies = _bodies(qs, ks, vs)
        want = _want_body(c["dtype"], c["D"])
        check(auto_body == want, f"kernel case {i}: auto takes {auto_body} "
              f"of {bodies}, expected {want}")
        check(c["dtype"] != torch.bfloat16 or "mma" in bodies,
              f"kernel case {i}: the mma body does not take it")
        tol = _case_tol(c, ref)
        for body in ["auto", *bodies]:
            before = dict(flash_attention.launches_by_body)
            if c["layout"] in ("bshd", "fused", "offset"):
                out = attention(q, k, v, body=body, **kw).transpose(1, 2)
            else:
                out = flash_attention(q, k, v, body=body, **kw)
            torch.cuda.synchronize()
            ran = [b for b, n in flash_attention.launches_by_body.items()
                   if n != before[b]]
            err = (out.float() - ref.float()).abs().max().item()
            emit("kernels", case=i,
                 shape=[c["B"], c["H"], c["Hkv"], c["S"], c["D"]],
                 dtype=str(c["dtype"]).replace("torch.", ""),
                 layout=c["layout"], **kw, body=body, ran=ran,
                 max_abs_err=err, tol=tol)
            check(ran == [auto_body if body == "auto" else body],
                  f"kernel case {i} body {body}: launched {ran}")
            check(math.isfinite(err) and err < tol,
                  f"kernel case {i} body {body}: error {err} >= {tol}")
            if i == 0 and body == "wgmma":
                serve_err = err
            if c == dict(WIDE_CASE) and body in ("wgmma", "mma"):
                wide_err[body] = err
            if c == TRAIN_CASE and body == "simt":
                train_err = err
            if body in ("wgmma", "mma") and [c[k] for k in GEMMA_LOCAL] == \
                    list(GEMMA_LOCAL.values()):
                window_err[body] = err
            for name, case in (("mla", MLA_CASE),
                               ("rg_local", _rg_local_case()),
                               ("whisper_enc", WHISPER_ENC)):
                if c == case and body in ("wgmma", "mma"):
                    family_err[name][body] = err
            if c == WHISPER_ENC and body in ("wgmma", "mma"):
                _drop_witness(q, k, v, ref, body, tol)
    check(len(window_err) == 2 and len(wide_err) == 2
          and all(len(e) == 2 for e in family_err.values()),
          "no wgmma or mma case at WIDE_CASE, GEMMA_LOCAL, MLA_CASE, "
          "RG_LOCAL or WHISPER_ENC")
    return serve_err, wide_err, train_err, window_err, family_err


def _case_tol(c: dict, ref) -> float:
    """A kernel case's bound: TOL by dtype; at WHISPER_ENC 2e-2 x max|ref|
    + 1e-3 as in phase logits, since 1500 keys in both directions leave a
    typical |out| near 0.03, about TOL[bf16] itself."""
    if c == WHISPER_ENC:
        return 2e-2 * ref.float().abs().max().item() + 1e-3
    return TOL[c["dtype"]]


def _drop_witness(q, k, v, ref, body: str, tol: float) -> None:
    """WHISPER_ENC's bound catches a kernel that skips keys: the body with
    its last WHISPER_DROP keys masked (kv_len), held against the full
    reference, must be off by ``tol`` or more."""
    from repro_torch.kernels.flash_attention import attention
    S = q.shape[1]
    out = attention(q, k, v, body=body, causal=False,
                    kv_len=S - WHISPER_DROP).transpose(1, 2)
    err = (out.float() - ref.float()).abs().max().item()
    emit("kernels", check="whisper_enc_drop_witness", body=body,
         kv_len=S - WHISPER_DROP, max_abs_err=err, tol=tol)
    check(err >= tol, f"WHISPER_ENC {body}: dropping {WHISPER_DROP} keys "
          f"gives {err} < {tol}: the bound cannot see it")


def _plain(q, k, v, *, causal=True, window=0, kv_len=None, f32=False):
    """attention_ref on the model's [B, S, H, D] layout; f32=True runs it on
    f32 copies (probabilities unrounded) and casts back."""
    from repro_torch.kernels.flash_attention import attention_ref
    args = [x.transpose(1, 2) for x in (q, k, v)]
    if f32:
        args = [x.float() for x in args]
    out = attention_ref(*args, causal=causal, window=window, kv_len=kv_len)
    return out.transpose(1, 2).to(q.dtype)


@contextlib.contextmanager
def model_attention(fn):
    """Route the model's prefill attention (the attention blocks', MLA's
    and the encoder-decoder's) through fn for one run."""
    from repro_torch.models import encdec, mla, transformer
    saved = transformer.attention
    transformer.attention = mla.attention = encdec.attention = fn
    try:
        yield saved
    finally:
        transformer.attention = mla.attention = encdec.attention = saved


def _bound(ref, got) -> tuple[float, float]:
    """Max abs error and its bound, 2e-2 * max|ref| + 1e-3 (bf16)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, 2e-2 * ref.float().abs().max().item() + 1e-3


def _prefill(model, toks, attn=None):
    cache = model.init_cache(toks.shape[0], SERVE_MAX_SEQ, dtype=torch.float32)
    if attn is None:
        return model.prefill({"tokens": toks}, cache)
    with model_attention(attn):
        return model.prefill({"tokens": toks}, cache)


def phase_serve(seed: int):
    """The main path at full width and depth, its launch count (flash
    attention's a prefill, the decode-attention kernel's calls a decode
    layer a step), and the kernel against its plain version on the q, k, v
    of every layer."""
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attention import attention, flash_attention
    from repro_torch.models.zoo import build
    from repro_torch.serve import ServeEngine

    cfg = configs.get("llama3.2-1b").scaled(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, (SERVE_B, SERVE_P)).astype(np.int32)
    eng = ServeEngine(model, max_seq=SERVE_MAX_SEQ, device="cuda")

    flash_attention.launches = 0
    eng.generate(prompts, max_new_tokens=SERVE_NEW)            # warm-up
    check(flash_attention.launches == cfg.n_layers,
          f"warm-up prefill launched the kernel {flash_attention.launches} "
          f"times, expected {cfg.n_layers}")

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    calls0 = decode_kernel_calls()
    out = eng.generate(prompts, max_new_tokens=SERVE_NEW)      # the main path
    launched = counts()
    decode_calls = decode_kernel_calls() - calls0
    launches = launched["flash_attention"]
    by_body = dict(flash_attention.launches_by_body)
    check(decode_calls == cache_attending(cfg) * SERVE_NEW,
          f"serving called the decode-attention kernel {decode_calls} "
          f"times, expected {cache_attending(cfg)} layers x {SERVE_NEW} "
          "steps")
    check(launched == dict(flash_attention=cfg.n_layers, range_mask=0,
                           dequant=0, dequant_packed=0, bitunpack=0,
                           page_unpack=0),
          f"serving launched {launched}, expected flash_attention "
          f"{cfg.n_layers} times and no other kernel")
    check(by_body == dict(simt=0, mma=0, wgmma=cfg.n_layers),
          f"serving launched the bodies {by_body}, expected wgmma "
          f"{cfg.n_layers} times and no other body")
    gen = out["tokens"]
    check(gen.shape == (SERVE_B, SERVE_NEW) and
          bool(((gen >= 0) & (gen < cfg.vocab)).all()), "generated tokens")
    # least times: a decode step reads every weight and the whole f32 cache
    # once; a prefill does the products of every non-embedding weight for
    # each prompt token, the causal attention, and the last token's logits
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cache_bytes = (2 * cfg.n_layers * SERVE_B * SERVE_MAX_SEQ * cfg.n_kv_heads
                   * cfg.head_dim * 4)
    decode_bound_s = (param_bytes + cache_bytes) / HBM_BYTES_PER_S
    embed = cfg.vocab * cfg.d_model
    prefill_flops = (2 * (model.n_params - embed) * SERVE_B * SERVE_P
                     + cfg.n_layers * 4 * cfg.head_dim * cfg.n_heads * SERVE_B
                     * SERVE_P * (SERVE_P + 1) // 2 + 2 * embed * SERVE_B)
    prefill_bound_s = max(prefill_flops / BF16_FLOP_PER_S,
                          param_bytes / HBM_BYTES_PER_S)
    emit("serve", arch=cfg.name, n_params=model.n_params,
         n_layers=cfg.n_layers, batch=SERVE_B, prompt_len=SERVE_P,
         new_tokens=SERVE_NEW, max_seq=SERVE_MAX_SEQ, init_s=init_s,
         prefill_ms=out["prefill_s"] * 1e3,
         decode_ms_per_step=out["decode_s"] * 1e3 / SERVE_NEW,
         decode_tok_per_s=out["decode_tok_per_s"],
         prefill_bound_ms=prefill_bound_s * 1e3, prefill_flops=prefill_flops,
         decode_bound_ms_per_step=decode_bound_s * 1e3,
         decode_bytes_per_step=param_bytes + cache_bytes,
         decode_tok_per_s_bound=SERVE_B / decode_bound_s,
         flash_launches_per_prefill=launches,
         flash_launches_by_body=by_body, decode_kernel_calls=decode_calls,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         first_tokens=gen[0, :8].tolist())

    layer_errs = []

    def both(q, k, v, **kw):
        got = attention(q, k, v, **kw)
        layer_errs.append(_bound(_plain(q, k, v, **kw), got))
        return got

    with torch.inference_mode():
        toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
        lg_kernel, _ = _prefill(model, toks, both)
        check(bool(torch.isfinite(lg_kernel).all()), "prefill logits finite")
        emit("serve", check="kernel_vs_plain_per_layer",
             max_abs_err=[e for e, _ in layer_errs],
             bound=[b for _, b in layer_errs])
        check(len(layer_errs) == cfg.n_layers and
              all(e < b for e, b in layer_errs), "per-layer kernel error")
        # Not a check: at full depth the random-init model amplifies any
        # rounding change (see PERF.md); the plain version moved by a
        # rounding change alone is the yardstick for the kernel's distance.
        lg_plain, _ = _prefill(model, toks, _plain)
        lg_plain32, _ = _prefill(model, toks, functools.partial(_plain, f32=True))
        emit("serve", diagnostic="full_depth_last_token_logits",
             max_abs_logit=lg_plain.float().abs().max().item(),
             kernel_vs_plain=_bound(lg_plain, lg_kernel)[0],
             plain_vs_plain_f32_probs=_bound(lg_plain, lg_plain32)[0])
    return model, prompts, gen, launches, decode_calls, dict(
        prefill_ms=out["prefill_s"] * 1e3,
        decode_ms_per_step=out["decode_s"] * 1e3 / SERVE_NEW,
        prefill_bound_ms=prefill_bound_s * 1e3)


def phase_logits(seed: int, gen) -> None:
    """The logit checks of the serving path at full width, depth cut to one
    layer: prefill through the kernel vs through the plain version, and
    decode steps vs a fresh prefill of prompt + generated tokens."""
    import repro_torch.configs as configs
    from repro_torch.models.zoo import build

    cfg = configs.get("llama3.2-1b").scaled(
        compute_dtype="bfloat16", segments=((("full:swiglu",), 1),))
    model = build(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, (SERVE_B, SERVE_P))
    with torch.inference_mode():
        toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
        lg_kernel, cache = _prefill(model, toks)
        lg_plain, _ = _prefill(model, toks, _plain)
        check(bool(torch.isfinite(lg_kernel).all()), "prefill logits finite")
        err, bound = _bound(lg_plain, lg_kernel)
        emit("logits", n_layers=cfg.n_layers, check="prefill_kernel_vs_plain",
             max_abs_err=err, bound=bound)
        check(err < bound, f"prefill logits: {err} >= {bound}")

        gen_t = torch.as_tensor(gen, dtype=torch.int64, device="cuda")
        for i in range(SERVE_NEW):
            lg_dec, cache = model.decode_step(cache, gen_t[:, i:i + 1])
            if i not in (0, SERVE_NEW - 1):
                continue
            lg_full, _ = _prefill(model, torch.cat([toks, gen_t[:, :i + 1]], 1))
            check(bool(torch.isfinite(lg_dec).all()), "decode logits finite")
            err, bound = _bound(lg_full, lg_dec)
            emit("logits", n_layers=cfg.n_layers, check="decode_vs_fresh_prefill",
                 step=i, position=SERVE_P + i, max_abs_err=err, bound=bound)
            check(err < bound, f"decode step {i}: {err} >= {bound}")


def _kernel_table(prof, top: int = 8, ranges=(),
                  averages=None) -> tuple[float, list]:
    """Device kernels only (host-side operator rows would count them twice,
    and so would the device rows of the record_function ``ranges``);
    ``averages``: ``prof.key_averages()`` where the caller has it."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in (averages or prof.key_averages())
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in ranges]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return total, [{"name": n[:80], "device_ms": us / 1e3, "calls": c}
                   for n, us, c in rows[:top]]


def phase_profile(model, prompts) -> None:
    """Device time by kernel: one prefill, then 8 decode steps."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
        cache = model.init_cache(SERVE_B, SERVE_MAX_SEQ, dtype=torch.float32)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            lg, cache = model.prefill({"tokens": toks}, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev, table = _kernel_table(prof)
        emit("profile", what="prefill", wall_ms=wall * 1e3, device_ms=dev / 1e3,
             busy_share=dev / 1e3 / (wall * 1e3), top=table)
        tok = lg.argmax(-1)[:, None]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(8):
                lg, cache = model.decode_step(cache, tok)
                tok = lg.argmax(-1)[:, None]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev, table = _kernel_table(prof)
        emit("profile", what="decode_8_steps", wall_ms=wall * 1e3,
             device_ms=dev / 1e3, busy_share=dev / 1e3 / (wall * 1e3),
             top=table)


def _mufu_ex2_per_s() -> float:
    """exp2 a second at the card's top SM clock: 16 a clock on each SM (the
    special-function units; Hopper tuning guide)."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16 * sms * float(mhz) * 1e6


def _live_pairs(S: int, window: int = 0, causal: bool = True) -> int:
    """Live (query, key) pairs of a call over S positions: query i sees
    i + 1 keys where causal, at most ``window`` of them where window > 0;
    all S where not causal (no window)."""
    if not causal:
        check(window <= 0, "a non-causal call with a window")
        return S * S
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _flash_work(B, H, Hkv, S, D, size, window=0, causal=True):
    """Bytes a call must move (each input read once, the output written
    once) and the products of its live (query, key) pairs."""
    live_pairs = B * H * _live_pairs(S, window, causal)
    return (2 * B * S * H + 2 * B * S * Hkv) * D * size, 4 * D * live_pairs, \
        live_pairs


WIDE_D = dict(B=1, H=8, Hkv=8, S=1024)    # the D > 256 route, at D = 512


def phase_times(seed: int) -> tuple[dict, dict]:
    """Flash attention at the serving shape: the wgmma body (the main
    path's) against its bound, its plain version and the library call, and
    the mma body beside it, all in device time, warm and cold in L2. Then
    the wgmma body at WIDE_CASE (D = 256) the same way, the mma body beside
    it; and the mma and simt bodies at D = 512 (slices of 256 columns)."""
    from repro_torch.kernels.flash_attention import attention, attention_ref
    c = SERVE_CASE
    B, H, Hkv, S, D = c["B"], c["H"], c["Hkv"], c["S"], c["D"]
    q, k, v = _inputs(np.random.default_rng(seed), B, H, Hkv, S, D,
                      c["dtype"], "bshd")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # least time for the same work: each input read once, the output written
    # once; the causal products of the live (query, key) pairs of this run.
    # exp_ms, one exp2 a live score at the MUFU rate, is printed beside it.
    bytes_moved, flops, live_pairs = _flash_work(B, H, Hkv, S, D,
                                                 q.element_size())
    row, extra = _time_kernel(
        lambda: attention(q, k, v, causal=True, body="wgmma"),
        lambda: attention_ref(qt, kt, vt, causal=True),
        bytes_moved=bytes_moved, ops=flops, op_rate=BF16_FLOP_PER_S,
        library=lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    flush = torch.empty(2**27, dtype=torch.uint8, device="cuda")
    mma_ms, mma_cold_ms = _warm_cold_ms(
        lambda: attention(q, k, v, causal=True, body="mma"), flush)
    emit("times", shape=[B, H, Hkv, S, D], dtype="bfloat16", causal=True,
         body="wgmma", **extra, live_scores=live_pairs,
         exp_ms=live_pairs / _mufu_ex2_per_s() * 1e3,
         mma_ms=mma_ms, mma_cold_l2_ms=mma_cold_ms,
         mma_over_wgmma=mma_ms / row["ms"],
         wgmma_over_library=row["ms"] / row["library_ms"], **row)

    c = WIDE_CASE
    B, H, Hkv, S, D = c["B"], c["H"], c["Hkv"], c["S"], c["D"]
    q, k, v = _inputs(np.random.default_rng(seed), B, H, Hkv, S, D,
                      c["dtype"], "bshd")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    bytes_moved, flops, live_pairs = _flash_work(B, H, Hkv, S, D,
                                                 q.element_size())
    wide, extra = _time_kernel(
        lambda: attention(q, k, v, causal=True, body="wgmma"),
        lambda: attention_ref(qt, kt, vt, causal=True),
        bytes_moved=bytes_moved, ops=flops, op_rate=BF16_FLOP_PER_S,
        library=lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    mma_ms, mma_cold_ms = _warm_cold_ms(
        lambda: attention(q, k, v, causal=True, body="mma"), flush)
    wide.update(mma_ms=mma_ms, mma_cold_l2_ms=mma_cold_ms)
    emit("times", shape=[B, H, Hkv, S, D], dtype="bfloat16", causal=True,
         body="wgmma", **extra, live_scores=live_pairs,
         exp_ms=live_pairs / _mufu_ex2_per_s() * 1e3,
         mma_over_wgmma=mma_ms / wide["ms"],
         wgmma_over_library=wide["ms"] / wide["library_ms"], **wide)

    # D > 256: exact and slow (the scores once a slice of 256 columns)
    B, H, Hkv, S = WIDE_D.values()
    for dtype, body in ((torch.bfloat16, "mma"), (torch.float32, "simt")):
        q, k, v = _inputs(np.random.default_rng(seed), B, H, Hkv, S, 512,
                          dtype, "bshd")
        bytes_moved, flops, live_pairs = _flash_work(B, H, Hkv, S, 512,
                                                     q.element_size())
        ms = _device_ms_per_call(
            lambda: attention(q, k, v, causal=True, body=body))
        rate = BF16_FLOP_PER_S if body == "mma" else F32_FLOP_PER_S
        bound_ms = max(bytes_moved / HBM_BYTES_PER_S, flops / rate) * 1e3
        emit("times", shape=[B, H, Hkv, S, 512],
             dtype=str(dtype).replace("torch.", ""), causal=True, body=body,
             ms=ms, bound_ms=bound_ms, roofline_share=bound_ms / ms,
             slices=2, l2="warm")
    return row, wide


GEMMA_LOCAL = dict(B=2, H=16, Hkv=8, S=2048, D=256, window=1024)
GEMM_NAMES = ("gemm", "nvjet", "cutlass")   # cuBLAS's kernels by name


def phase_window_times(seed: int) -> dict:
    """The wgmma body at a gemma3-12b local layer's prefill (GEMMA_LOCAL: a
    prompt of twice the window, so the kernel skips the key tiles before
    it), warm and cold in L2, against the bound of the window's live pairs,
    its plain version and SDPA given the equivalent boolean mask; the mma
    body's times beside it."""
    from repro_torch.kernels.flash_attention import attention, attention_ref
    c = GEMMA_LOCAL
    B, H, Hkv, S, D, W = (c[k] for k in ("B", "H", "Hkv", "S", "D", "window"))
    q, k, v = _inputs(np.random.default_rng(seed), B, H, Hkv, S, D,
                      torch.bfloat16, "bshd")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    pos = torch.arange(S, device="cuda")
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bytes_moved, flops, live_pairs = _flash_work(B, H, Hkv, S, D,
                                                 q.element_size(), window=W)
    row, extra = _time_kernel(
        lambda: attention(q, k, v, causal=True, window=W, body="wgmma"),
        lambda: attention_ref(qt, kt, vt, causal=True, window=W),
        bytes_moved=bytes_moved, ops=flops, op_rate=BF16_FLOP_PER_S,
        library=lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    flush = torch.empty(2**27, dtype=torch.uint8, device="cuda")
    mma_ms, mma_cold_ms = _warm_cold_ms(
        lambda: attention(q, k, v, causal=True, window=W, body="mma"), flush)
    row.update(mma_ms=mma_ms, mma_cold_l2_ms=mma_cold_ms)
    emit("window_times", shape=[B, H, Hkv, S, D], dtype="bfloat16",
         causal=True, window=W, body="wgmma", **extra,
         live_scores=live_pairs,
         live_share=live_pairs / (B * H * S * (S + 1) // 2),
         library_call="SDPA, boolean causal-and-window mask",
         mma_over_wgmma=mma_ms / row["ms"],
         wgmma_over_library=row["ms"] / row["library_ms"], **row)
    return row


def phase_family_times(seed: int) -> dict:
    """The wgmma body at the new families' prefill shapes, warm and cold in
    L2, against its bound, its plain version and SDPA. MLA_CASE: the
    padded call the model makes (q, k and V padded to 96), its bound from
    ``_flash_work`` at D = 96, the unpadded MLA call's bound (V and the
    output at 64) beside it, and SDPA given q, k at 96 and V at 64
    unpadded. RG_LOCAL: recurrentgemma-9b's local layer (MQA, window 2048,
    a prompt of twice the window) beside SDPA with the boolean
    causal-and-window mask. WHISPER_ENC: whisper-base's encoder attention
    (not causal, S = 1500) beside SDPA unmasked, and the mma body."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention, attention_ref
    sdpa = F.scaled_dot_product_attention
    out = {}
    c = MLA_CASE
    B, H, Hkv, S, D = (c[k] for k in ("B", "H", "Hkv", "S", "D"))
    q, k, v64 = _inputs(np.random.default_rng(seed), B, H, Hkv, S, D,
                        torch.bfloat16, "bshd")
    v64 = v64[..., :MLA_DV].contiguous()
    v = F.pad(v64, (0, D - MLA_DV))
    qt, kt, vt64 = q.transpose(1, 2), k.transpose(1, 2), v64.transpose(1, 2)
    bytes_moved, flops, live_pairs = _flash_work(B, H, Hkv, S, D,
                                                 q.element_size())
    row, extra = _time_kernel(
        lambda: attention(q, k, v, causal=True, body="wgmma"),
        lambda: attention_ref(qt, kt, v.transpose(1, 2), causal=True),
        bytes_moved=bytes_moved, ops=flops, op_rate=BF16_FLOP_PER_S,
        library=lambda: sdpa(qt, kt, vt64, is_causal=True))
    got = attention(q, k, v, causal=True)[..., :MLA_DV]
    lib = sdpa(qt, kt, vt64, is_causal=True).transpose(1, 2)
    err, bound = _bound(lib, got)
    check(err < bound, f"MLA shape: padded kernel vs SDPA at dv 64: "
          f"{err} >= {bound}")
    # the unpadded MLA work: q, k at 96, V and the output at 64; QK^T at 96
    # and PV at 64 for each live (query, key) pair of each head
    mla_bytes = B * S * H * q.element_size() * (2 * D + 2 * MLA_DV)
    mla_ops = 2 * (D + MLA_DV) * live_pairs
    mla_bound_ms = max(mla_bytes / HBM_BYTES_PER_S,
                       mla_ops / BF16_FLOP_PER_S) * 1e3
    emit("family_times", shape=[B, H, Hkv, S, D], dv=MLA_DV,
         dtype="bfloat16", causal=True, body="wgmma", arch="minicpm3-4b",
         **extra, live_scores=live_pairs, unpadded_bound_ms=mla_bound_ms,
         unpadded_roofline_share=mla_bound_ms / row["ms"],
         library_call="SDPA, q and k at 96, V at 64 unpadded",
         padded_vs_sdpa_max_abs_err=err,
         wgmma_over_library=row["ms"] / row["library_ms"], **row)
    out["mla"] = dict(row, unpadded_bound_ms=mla_bound_ms,
                      cold_l2_ms=extra["cold_l2_ms"])

    c = RG_LOCAL
    B, H, Hkv, S, D, W = (c[k] for k in ("B", "H", "Hkv", "S", "D",
                                         "window"))
    q, k, v = _inputs(np.random.default_rng(seed), B, H, Hkv, S, D,
                      torch.bfloat16, "bshd")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    pos = torch.arange(S, device="cuda")
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W)
    bytes_moved, flops, live_pairs = _flash_work(B, H, Hkv, S, D,
                                                 q.element_size(), window=W)
    row, extra = _time_kernel(
        lambda: attention(q, k, v, causal=True, window=W, body="wgmma"),
        lambda: attention_ref(qt, kt, vt, causal=True, window=W),
        bytes_moved=bytes_moved, ops=flops, op_rate=BF16_FLOP_PER_S,
        library=lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    emit("family_times", shape=[B, H, Hkv, S, D], dtype="bfloat16",
         causal=True, window=W, body="wgmma", arch="recurrentgemma-9b",
         **extra, live_scores=live_pairs,
         live_share=live_pairs / (B * H * S * (S + 1) // 2),
         library_call="SDPA, boolean causal-and-window mask",
         wgmma_over_library=row["ms"] / row["library_ms"], **row)
    out["rg_local"] = dict(row, cold_l2_ms=extra["cold_l2_ms"])

    c = WHISPER_ENC
    B, H, Hkv, S, D = (c[k] for k in ("B", "H", "Hkv", "S", "D"))
    q, k, v = _inputs(np.random.default_rng(seed), B, H, Hkv, S, D,
                      torch.bfloat16, "bshd")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    bytes_moved, flops, live_pairs = _flash_work(B, H, Hkv, S, D,
                                                 q.element_size(),
                                                 causal=False)
    row, extra = _time_kernel(
        lambda: attention(q, k, v, causal=False, body="wgmma"),
        lambda: attention_ref(qt, kt, vt, causal=False),
        bytes_moved=bytes_moved, ops=flops, op_rate=BF16_FLOP_PER_S,
        library=lambda: sdpa(qt, kt, vt))
    flush = torch.empty(2**27, dtype=torch.uint8, device="cuda")
    mma_ms, mma_cold_ms = _warm_cold_ms(
        lambda: attention(q, k, v, causal=False, body="mma"), flush)
    row.update(mma_ms=mma_ms, mma_cold_l2_ms=mma_cold_ms)
    emit("family_times", shape=[B, H, Hkv, S, D], dtype="bfloat16",
         causal=False, body="wgmma", arch="whisper-base", **extra,
         live_scores=live_pairs,
         library_call="SDPA, not causal, no mask",
         mma_over_wgmma=mma_ms / row["ms"],
         wgmma_over_library=row["ms"] / row["library_ms"], **row)
    out["whisper_enc"] = dict(row, cold_l2_ms=extra["cold_l2_ms"])
    return out


# decode attention at the generate cells' shapes, mid-decode: deepseek-
# moe-16b (B 32, 16 heads of 128, MHA, a prompt of 512 and 64 new tokens:
# step 32) and the mixtral-8x22b stage (48 query heads over 8 kv heads,
# 2048 + 128: step 64); bf16 queries over the f32 cache, as ServeEngine
# keeps it
DECODE_CASES = {
    "dsmoe": dict(B=32, H=16, Hkv=16, S=576, D=128, pos=544, layers=28),
    "mixtral_stage": dict(B=32, H=48, Hkv=8, S=2176, D=128, pos=2112,
                          layers=10),
}


def _bf16_gaps(got, want, mag) -> tuple[float, float]:
    """How far ``got`` lies from ``want``: the largest gap in bf16 ulps of
    ``mag``, each output's sum of p_j |v_j| (a probability that two
    computations round to neighbouring bf16 values moves the output by its
    ulp times |v_j|, whatever the output's own size), and the share of
    outputs that differ at all."""
    mag = mag.float().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    gap = (got.float() - want.float()).abs() / ulp
    return float(gap.max()), float((got != want).float().mean())


def phase_decode_attention(seed: int) -> dict:
    """The decode-attention kernel at DECODE_CASES against its plain
    version on the card (``decode_attention_ref``: the path it replaced,
    the cache cast to q's dtype and ``dot_attention``), within one bf16
    ulp of each output's sum of p_j |v_j| and with at most 5% of the
    outputs other than the plain version's (``_bf16_gaps``, the limits of
    the card tests); its device time warm and cold in L2 beside its bound
    (the valid slots' K and V in f32, q and the output, at 3.35 TB/s), the
    plain version's (a layer's, and times the model's layers: the step's
    share that the kernel replaces) and SDPA's (the yardstick only: f32 q
    over the valid slots of the f32 cache, ``enable_gqa``; the port never
    calls it), and each of its kernels' time from the profiler. Returns
    the rows of the kernels line."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    rng = np.random.default_rng(seed + 32)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, c in DECODE_CASES.items():
        B, H, Hkv, S, D, at = (c[k] for k in ("B", "H", "Hkv", "S", "D",
                                              "pos"))

        def rand(*shape):
            return torch.as_tensor(rng.standard_normal(shape, np.float32),
                                   device="cuda")
        q = rand(B, 1, H, D).to(torch.bfloat16)
        k, v = rand(B, S, Hkv, D), rand(B, S, Hkv, D)
        pos = torch.tensor(at, device="cuda")
        n = at + 1
        before = decode_attention.launches
        got = decode_attention(q, k, v, pos)
        plain = decode_attention_ref(q, k, v, pos)
        mag = decode_attention_ref(q, k, v.abs(), pos)
        torch.cuda.synchronize()
        check(decode_attention.launches == before + 1,
              f"decode_attention {name}: launches")
        ulps, diff_share = _bf16_gaps(got, plain, mag)
        check(bool(torch.isfinite(got).all()) and ulps <= 1
              and diff_share <= 0.05, f"decode_attention {name}: {ulps} "
              f"bf16 ulps and {diff_share} of the outputs from the plain "
              "version")
        qf = q.float().transpose(1, 2)
        kt, vt = k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
        bytes_moved = 2 * B * n * Hkv * D * k.element_size() \
            + 2 * B * H * D * q.element_size()
        row, extra = _time_kernel(
            lambda: decode_attention(q, k, v, pos),
            lambda: decode_attention_ref(q, k, v, pos),
            bytes_moved=bytes_moved, ops=4 * B * H * n * D,
            op_rate=F32_FLOP_PER_S,
            library=lambda: sdpa(qf, kt, vt, enable_gqa=H != Hkv))
        passes = {re.search(r"decode_attn_[a-z]+", key).group(0)
                  if "decode_attn_" in key else key: us for key, us
                  in _device_us(lambda: decode_attention(q, k, v, pos))
                  .items()}
        row.update(pass_us=passes, kernels_a_call=len(passes),
                   plain_ms_per_step=row["plain_ms"] * c["layers"],
                   kernel_ms_per_step=row["ms"] * c["layers"])
        emit("decode_attention", case=name, shape=[B, H, Hkv, S, D],
             pos=at, valid_slots=n, layers=c["layers"], q_dtype="bfloat16",
             cache_dtype="float32", ulps_vs_plain=ulps,
             diff_share_vs_plain=diff_share,
             library_call="SDPA, f32 q over the valid slots, enable_gqa",
             plain_over_kernel=row["plain_ms"] / row["ms"], **extra, **row)
        rows[name] = dict(shape=[B, H, Hkv, S, D], pos=at,
                          ulps_vs_plain=ulps,
                          diff_share_vs_plain=diff_share, **row)
        del q, k, v, kt, vt, got, plain, mag
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def _moe_probes(drops: list):
    """Name the routed experts' products in the profiler (a record_function
    range around ``moe._experts``) and keep each dispatch's dropped pairs
    (a device tensor, so nothing waits for the card) in ``drops``."""
    from torch.profiler import record_function
    from repro_torch.models import moe
    saved = moe._experts, moe._dispatch

    def experts(*a, **k):
        with record_function("moe_experts"):
            return saved[0](*a, **k)

    def dispatch(xt, idx, E, C):
        out = saved[1](xt, idx, E, C)
        drops.append(((~out[2]).sum(), out[2].numel()))
        return out

    moe._experts, moe._dispatch = experts, dispatch
    try:
        yield
    finally:
        moe._experts, moe._dispatch = saved


def _family_profile(model, prompts, max_seq: int, steps: int = 4,
                    frames=None) -> dict:
    """One prefill and ``steps`` decode steps under torch.profiler: device
    time, busy share, the flash kernel's and the GEMMs' device time, the
    routed experts' device time (range ``moe_experts``), the pairs
    dropped by capacity, and whether the last logits are finite. Host
    operators are recorded only for the MoE families (their range needs
    them): rwkv6-7b's loop over time launches about 10^5 kernels a
    prefill, and each host record costs the profiler's processing time.
    ``frames``: an encoder-decoder's, copied to the card before the
    prefill's profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    moe = any(b.endswith(":moe") for bl, _ in model.cfg.segments for b in bl)
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if moe else [])
    out = {}
    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                           device="cuda")}
        if frames is not None:
            batch["frames"] = torch.as_tensor(frames, device="cuda")
        cache = model.init_cache(len(prompts), max_seq, dtype=torch.float32)
        for what in ("prefill", f"decode_{steps}_steps"):
            drops: list = []
            torch.cuda.synchronize()
            with _moe_probes(drops), profile(activities=acts) as prof:
                t0 = time.perf_counter()
                if what == "prefill":
                    lg, cache = model.prefill(batch, cache)
                else:
                    for _ in range(steps):
                        lg, cache = model.decode_step(
                            cache, lg.argmax(-1)[:, None])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            averages = prof.key_averages()
            dev, table = _kernel_table(prof, top=6, ranges=("moe_experts",),
                                       averages=averages)
            kernels = [e for e in averages
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0
                       and e.key != "moe_experts"]
            experts = max([e.device_time_total for e in averages
                           if e.key == "moe_experts"], default=0)
            flash = sum(e.self_device_time_total for e in kernels
                        if "flash_fwd" in e.key)
            out[what] = dict(
                wall_ms=wall * 1e3, device_ms=dev / 1e3,
                busy_share=dev / 1e3 / (wall * 1e3),
                flash_ms=flash / 1e3, flash_share=flash / dev if dev else None,
                gemm_ms=sum(e.self_device_time_total for e in kernels
                            if any(n in e.key.lower() for n in GEMM_NAMES))
            / 1e3,
                moe_experts_ms=experts / 1e3,
                dropped_pairs=int(sum(int(d) for d, _ in drops)),
                routed_pairs=int(sum(n for _, n in drops)),
                logits_finite=bool(torch.isfinite(lg).all()), top=table)
    return out


def _serve_bounds(model, cfg, B: int, P: int, max_seq: int) -> dict:
    """Least times of the serving path. A prefill does the products of
    every non-embedding weight a token uses (the routed experts' top_k of
    n_experts), the causal attention's live pairs (within the window where
    there is one; QK^T at the kernel's head dim and PV at V's, 64 for MLA)
    and the last token's logits; it reads every weight once. The
    recurrences' elementwise work (RG-LRU's scan, RWKV's WKV: under 1% of
    the products at these widths) is left out. A decode step reads every
    weight but the unrouted experts' (at most B * top_k of n_experts a
    layer) and the whole f32 cache once, and writes the recurrent states
    (RWKV's S, RG-LRU's h and conv) once: each of a block's cache tensors
    as ``transformer.block_cache`` declares it."""
    from repro_torch.models import transformer as tf
    if cfg.encoder is not None:
        return _encdec_bounds(model, cfg, B, P, max_seq)
    head = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    expert = sum(p.numel() for n, p in model.named_parameters()
                 if ".moe.w" in n)
    share = cfg.top_k / cfg.n_experts if expert else 0.0
    active = model.n_params - head - expert + expert * share
    live = sum(rep * _live_pairs(P, w) for w, rep in _windows(cfg).items())
    dv = cfg.mla.v_head_dim if cfg.mla is not None else cfg.head_dim
    flops = (2 * active * B * P + 2 * (_attn_dim(cfg) + dv) * cfg.n_heads
             * B * live + 2 * cfg.vocab * cfg.d_model * B)
    size = 2                                            # bf16 weights
    param_bytes = model.n_params * size
    cache_bytes = state_bytes = 0
    for blocks, rep in cfg.segments:
        for b in blocks:
            c = tf.block_cache(cfg, b, B, max_seq, torch.float32,
                               device="meta")
            n = rep * sum(t.numel() * t.element_size() for t in c.values())
            if b.split(":")[0] in ("rwkv", "rglru"):
                state_bytes += n
            else:
                cache_bytes += n
    routed = min(1.0, B * share) if expert else 0.0
    step_bytes = ((param_bytes - expert * size * (1 - routed)) + cache_bytes
                  + 2 * state_bytes)
    prefill_s = max(flops / BF16_FLOP_PER_S, param_bytes / HBM_BYTES_PER_S)
    return dict(prefill_bound_ms=prefill_s * 1e3, prefill_flops=int(flops),
                decode_bound_ms_per_step=step_bytes / HBM_BYTES_PER_S * 1e3,
                decode_bytes_per_step=int(step_bytes),
                cache_bytes=int(cache_bytes),
                recurrent_state_bytes=int(state_bytes))


def _encdec_bounds(model, cfg, B: int, P: int, max_seq: int) -> dict:
    """``_serve_bounds`` of an encoder-decoder. A prefill does the encoder's
    products over B x encoder.seq frames and its attention over all S^2
    pairs of each clip, the cross K and V of every decoder layer over the
    frames, the decoder's other products over B x P tokens, its causal
    self-attention and its cross-attention over P x S pairs, and the last
    token's logits; it reads every weight and the f32 frames once and
    writes the f32 cross K/V cache once. A decode step reads the weights
    the decoder uses (not the encoder's, not the cross K/V projections)
    and the whole f32 cache, the self K/V and the cross K/V, once."""
    S, H, D = cfg.encoder.seq, cfg.n_heads, cfg.head_dim
    L_enc, L_dec = cfg.encoder.n_layers, cfg.n_layers
    sizes = {n: p.numel() for n, p in model.named_parameters()}
    enc = sum(n for k, n in sizes.items() if k.startswith("enc_"))
    cross_kv = sum(n for k, n in sizes.items()
                   if ".cross_attn.wk" in k or ".cross_attn.wv" in k)
    dec = sum(n for k, n in sizes.items() if k.startswith("dec_")) - cross_kv
    head = cfg.vocab * cfg.d_model
    parts = dict(
        encoder_products=2 * enc * B * S,
        encoder_attention=4 * D * H * B * _live_pairs(S, causal=False) * L_enc,
        cross_kv=2 * cross_kv * B * S,
        decoder=(2 * dec * B * P + 4 * D * H * B * _live_pairs(P) * L_dec
                 + 4 * D * H * B * P * S * L_dec + 2 * head * B))
    flops = sum(parts.values())
    size = 2                                            # bf16 weights
    cross_bytes = 2 * L_dec * B * S * H * D * 4         # f32 cache
    self_bytes = 2 * L_dec * B * max_seq * cfg.n_kv_heads * D * 4
    prefill_bytes = (model.n_params * size + B * S * cfg.d_model * 4
                     + cross_bytes)
    step_bytes = (dec + head) * size + self_bytes + cross_bytes
    prefill_s = max(flops / BF16_FLOP_PER_S, prefill_bytes / HBM_BYTES_PER_S)
    return dict(prefill_bound_ms=prefill_s * 1e3, prefill_flops=int(flops),
                prefill_flops_by_part={k: int(v) for k, v in parts.items()},
                prefill_bytes=int(prefill_bytes),
                decode_bound_ms_per_step=step_bytes / HBM_BYTES_PER_S * 1e3,
                decode_bytes_per_step=int(step_bytes),
                cache_bytes=int(self_bytes + cross_bytes),
                recurrent_state_bytes=0)


F32_EXP_MAX = math.log(torch.finfo(torch.float32).max)     # 88.72
WKV_CLAMP = -60.0    # wkv_chunked's floor on a chunk's cumulative log-decay


def _wkv_overflow_probe(model, prompts, max_seq: int) -> dict:
    """Where a prefill through ``wkv_chunked`` turns non-finite, and why.
    Each layer's call is recorded: whether its inputs and its output are
    finite, its least log-decay, and whether ``k / prod w`` (its
    ``k * exp(-ce - lw)``, ce the exclusive cumulative log-decay clamped at
    WKV_CLAMP) is finite. Past the clamp, a step whose log-decay is below
    -(F32_EXP_MAX + WKV_CLAMP) overflows f32 there, and the chunk's
    outputs after it turn to inf or NaN: the reference's form, which the
    port copies (``tests/test_torch_rwkv.py``). Returns the first layer
    with a non-finite output, with its record."""
    from repro_torch.models import rwkv6
    chunked, calls = rwkv6.wkv_chunked, []

    def probe(r, k, v, w, u, state, chunk: int = 64):
        y, S = chunked(r, k, v, w, u, state, chunk)
        B, T, H, D = r.shape
        lw = torch.log(torch.clamp(w.reshape(B, -1, chunk, H, D).float(),
                                   min=1e-38))
        ce = torch.clamp(torch.cumsum(lw, dim=2) - lw, min=WKV_CLAMP)
        k_dec = k.reshape(lw.shape).float() * torch.exp(-ce - lw)
        calls.append(dict(
            inputs_finite=all(bool(torch.isfinite(t).all())
                              for t in (r, k, v, w, state)),
            min_log_w=lw.min().item(),
            max_exponent=(-ce - lw).max().item(),
            k_dec_finite=bool(torch.isfinite(k_dec).all()),
            output_finite=bool(torch.isfinite(y).all()
                               and torch.isfinite(S).all())))
        return y, S

    B = prompts.shape[0]
    rwkv6.wkv_chunked = probe
    try:
        with torch.inference_mode():
            toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
            model.prefill({"tokens": toks},
                          model.init_cache(B, max_seq, dtype=torch.float32))
    finally:
        rwkv6.wkv_chunked = chunked
    first = next((i for i, c in enumerate(calls)
                  if not c["output_finite"]), None)
    return dict(layers=len(calls), first_non_finite_layer=first,
                exponent_limit=F32_EXP_MAX,
                **(calls[first] if first is not None else {}))


def _depth_witness(model, prompts, frames, max_seq: int) -> None:
    """Not a check: the served model's last-token prefill logits through
    the kernel, the plain version and the plain version with f32
    probabilities, and their distances, beside the bound of
    ``_family_logits``: where rounding the probabilities alone moves the
    logits past it, the logit checks hold fewer layers."""
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                       device="cuda")}
    if frames is not None:
        batch["frames"] = torch.as_tensor(frames, device="cuda")
    lg = {}
    with torch.inference_mode():
        for name, attn in (("kernel", None), ("plain", _plain),
                           ("plain_f32_probs",
                            functools.partial(_plain, f32=True))):
            cache = model.init_cache(len(prompts), max_seq,
                                     dtype=torch.float32)
            with model_attention(attn) if attn else contextlib.nullcontext():
                lg[name] = model.prefill(batch, cache)[0]
    emit("families", arch=model.cfg.name, diagnostic="depth_witness",
         n_layers=model.cfg.n_layers,
         max_abs_logit=lg["plain_f32_probs"].float().abs().max().item(),
         bound=_bound(lg["plain_f32_probs"], lg["kernel"])[1],
         kernel_vs_plain_f32_probs=_bound(lg["plain_f32_probs"],
                                          lg["kernel"])[0],
         kernel_vs_plain=_bound(lg["plain"], lg["kernel"])[0],
         plain_vs_plain_f32_probs=_bound(lg["plain_f32_probs"],
                                         lg["plain"])[0])


def _frames(cfg, B: int, rng):
    """An encoder-decoder's stubbed front end: N(0, 1) frame embeddings
    [B, encoder.seq, d_model], f32 from numpy; None for a decoder-only
    model."""
    if cfg.encoder is None:
        return None
    return rng.normal(size=(B, cfg.encoder.seq, cfg.d_model)).astype(
        np.float32)


def _serve_family(seed: int, run: dict) -> tuple[int, int]:
    """One family's main path: build at full width (depth as FAMILY_RUNS
    says), serve through ServeEngine (an encoder-decoder given frames
    from the seed), check the launches (one a layer in the prefill, the
    body the rule gives, each with its block's window and causal flag),
    the decode-attention kernel's calls (one an attention layer a step)
    and the tokens, then profile a prefill and 4 decode steps.
    Returns the flash launches and the decode-attention kernel's calls of
    the main path."""
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.zoo import build
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    cfg = _family_cfg(run)
    full_layers = configs.get(run["arch"]).n_layers
    B, P, new, max_seq = run["B"], run["P"], run["new"], run["max_seq"]
    model = build(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
    frames = _frames(cfg, B, rng)
    eng = ServeEngine(model, max_seq=max_seq, device="cuda")
    eng.generate(prompts, max_new_tokens=2, frames=frames)     # warm-up

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    calls0 = decode_kernel_calls()
    out = eng.generate(prompts, max_new_tokens=new, frames=frames)  # main path
    launched = counts()
    decode_calls = decode_kernel_calls() - calls0
    by_body = {b: n for b, n in flash_attention.launches_by_body.items() if n}
    by_window = dict(flash_attention.launches_by_window)
    by_causal = dict(flash_attention.launches_by_causal)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    body = "wgmma"        # every family: aligned bf16, D <= 256
    attending = sum(_windows(cfg).values())
    check(launched == dict(flash_attention=attending, range_mask=0,
                           dequant=0, dequant_packed=0, bitunpack=0,
                           page_unpack=0),
          f"{cfg.name}: serving launched {launched}, expected "
          f"flash_attention {attending} times (once a layer that attends) "
          f"and no other kernel")
    check(by_body == ({body: attending} if attending else {}),
          f"{cfg.name}: bodies {by_body}, expected {body} {attending} times")
    check(by_window == _windows(cfg),
          f"{cfg.name}: launches by window {by_window}, expected "
          f"{_windows(cfg)}")
    check(by_causal == _causal(cfg),
          f"{cfg.name}: launches by causal flag {by_causal}, expected "
          f"{_causal(cfg)}")
    check(decode_calls == cache_attending(cfg) * new,
          f"{cfg.name}: decode-attention kernel called {decode_calls} "
          f"times, expected {cache_attending(cfg)} layers x {new} steps")
    gen = out["tokens"]
    check(gen.shape == (B, new) and
          bool(((gen >= 0) & (gen < cfg.vocab)).all()),
          f"{cfg.name}: generated tokens")
    prof = _family_profile(model, prompts, max_seq, frames=frames)
    if run.get("depth_witness"):
        _depth_witness(model, prompts, frames, max_seq)
    check(prof["prefill"]["dropped_pairs"] <= prof["prefill"]["routed_pairs"],
          "drop counts")
    finite = [prof[k]["logits_finite"] for k in prof]
    overflow = None
    if cfg.rwkv_chunked:
        # the chunked WKV's f32 overflow, a fault of the reference's form
        # (ROADMAP.md §3): its logits must stay non-finite, and for that
        # cause alone, so that a change either way shows here
        overflow = _wkv_overflow_probe(model, prompts, max_seq)
        first = overflow["first_non_finite_layer"]
        check(not prof["prefill"]["logits_finite"] and first is not None
              and overflow["inputs_finite"] and not overflow["k_dec_finite"],
              f"{cfg.name}: rwkv_chunked, expected non-finite logits from "
              f"the chunked WKV's overflow (ROADMAP.md §3), got finite "
              f"{finite}, probe {overflow}")
    else:
        check(all(finite), f"{cfg.name}: non-finite logits {finite}")
    emit("families", arch=cfg.name, label=_family_label(run),
         n_params=model.n_params, n_layers=cfg.n_layers,
         attending_layers=attending, full_depth_layers=full_layers,
         batch=B, prompt_len=P,
         new_tokens=new, max_seq=max_seq, window=cfg.window
         if any(_windows(cfg)) else None, init_s=init_s,
         prefill_ms=out["prefill_s"] * 1e3,
         decode_ms_per_step=out["decode_s"] * 1e3 / new,
         decode_tok_per_s=out["decode_tok_per_s"],
         **_serve_bounds(model, cfg, B, P, max_seq),
         flash_launches_per_prefill=launched["flash_attention"],
         flash_launches_by_body=by_body,
         flash_launches_by_window={str(w): n for w, n in by_window.items()},
         flash_launches_by_causal={str(c): n for c, n in by_causal.items()},
         decode_kernel_calls=decode_calls,
         encoder=dataclasses.asdict(cfg.encoder) if cfg.encoder else None,
         peak_mem_gb=peak_gb, first_tokens=gen[0, :8].tolist(),
         logits_finite=all(finite), wkv_overflow=overflow,
         profile=prof, host_s=time.perf_counter() - t0)
    del eng, model
    torch.cuda.empty_cache()
    return launched["flash_attention"], decode_calls


def _family_logits(cfg, seed: int, B: int, P: int, steps: int,
                   dtype=torch.bfloat16) -> None:
    """At full width and one pattern repeat. Prefill: the logits through
    the kernel against the same model with the plain version of attention
    in its place, computed with unrounded (f32) probabilities, the closer
    of the two plain versions to exact arithmetic; the bf16-probability
    plain version is printed beside it, with its own distance from the f32
    one: what rounding the probabilities alone does to these logits, more
    than the bound for deepseek-moe-16b (PERF.md). Decode: greedy steps
    against a fresh prefill of prompt + generated tokens through the
    kernel, as in phase logits (the cache's history came from the kernel);
    the fresh prefill through the bf16-probability plain version is
    printed beside it. Bound as in phase logits: 2e-2 x max|ref| + 1e-3,
    bf16's rounding (2**-8 relative, a few roundings deep) with room for
    the sums' order. ``dtype``: the weights' and the compute's (cfg's
    compute_dtype must name it)."""
    from repro_torch.models.zoo import build
    model = build(cfg, device="cuda", dtype=dtype, seed=seed)
    prompts = np.random.default_rng(seed + 1).integers(0, cfg.vocab, (B, P))
    frames = _frames(cfg, B, np.random.default_rng(seed + 4))
    if frames is not None:
        frames = torch.as_tensor(frames, device="cuda")
    max_seq = P + steps
    plain32 = functools.partial(_plain, f32=True)

    def prefill(toks, attn=None):
        cache = model.init_cache(B, max_seq, dtype=torch.float32)
        batch = {"tokens": toks}
        if frames is not None:
            batch["frames"] = frames
        if attn is None:
            return model.prefill(batch, cache)
        with model_attention(attn):
            return model.prefill(batch, cache)

    with torch.inference_mode():
        toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
        lg, cache = prefill(toks)
        lg_plain32, _ = prefill(toks, plain32)
        lg_plain, _ = prefill(toks, _plain)
        check(bool(torch.isfinite(lg).all()), f"{cfg.name}: prefill logits")
        err, bound = _bound(lg_plain32, lg)
        emit("family_logits", arch=cfg.name, n_layers=cfg.n_layers,
             encoder_layers=cfg.encoder.n_layers if cfg.encoder else None,
             dtype=str(dtype).replace("torch.", ""),
             window=cfg.window if any(_windows(cfg)) else None, prompt_len=P,
             check="prefill_kernel_vs_plain_f32_probs", max_abs_err=err,
             bound=bound, kernel_vs_plain=_bound(lg_plain, lg)[0],
             plain_vs_plain_f32_probs=_bound(lg_plain32, lg_plain)[0])
        check(err < bound, f"{cfg.name} prefill logits: {err} >= {bound}")
        gen = [lg.argmax(-1)[:, None]]
        for i in range(steps):
            lg_dec, cache = model.decode_step(cache, gen[-1])
            if i in (0, steps - 1):
                seq = torch.cat([toks, *gen], dim=1)
                lg_full, _ = prefill(seq)
                lg_full_plain, _ = prefill(seq, _plain)
                check(bool(torch.isfinite(lg_dec).all()),
                      f"{cfg.name}: decode logits")
                err, bound = _bound(lg_full, lg_dec)
                emit("family_logits", arch=cfg.name, n_layers=cfg.n_layers,
                     dtype=str(dtype).replace("torch.", ""),
                     check="decode_vs_fresh_prefill", step=i,
                     position=P + i, max_abs_err=err, bound=bound,
                     decode_vs_fresh_prefill_plain=_bound(lg_full_plain,
                                                          lg_dec)[0])
                check(err < bound,
                      f"{cfg.name} decode step {i}: {err} >= {bound}")
            gen.append(lg_dec.argmax(-1)[:, None])
    del model, cache
    torch.cuda.empty_cache()


def _local_layer_check(cfg, seed: int, B: int, P: int, steps: int) -> None:
    """recurrentgemma-9b's local attention layer alone, at full width and
    bf16: MQA, head_dim 256, its window, the wgmma body the served model
    runs. Held on the attention sublayer's output, before the residual
    add, where the attention is the whole signal (at the model's random
    init it moves the logits by less than one bf16 rounding). Prefill of
    P positions, past the window: through the kernel against the plain
    version with f32 probabilities. Then ``steps`` decode steps over the
    rolled cache, each against a fresh prefill of the positions so far
    through the kernel. Bound as in phase logits. The input is random
    normal: the block's RMSNorm takes out its scale."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as tf
    from repro_torch.models.zoo import build
    block = next(b for blocks, _ in cfg.segments for b in blocks
                 if b.startswith("local:"))
    lcfg = cfg.scaled(compute_dtype="bfloat16", segments=(((block,), 1),))
    model = build(lcfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    p = model["segments"][0]["b0"][0]
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    x = torch.randn(B, P + steps, lcfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)

    def sublayer(T, cache=None, attn=None):
        ctx = tf.Ctx(cfg=lcfg, mode="prefill",
                     positions=torch.arange(T, device="cuda"))
        if attn is None:
            return tf.attn_sublayer(p, x[:, :T], "local", ctx, cache)
        with model_attention(attn):
            return tf.attn_sublayer(p, x[:, :T], "local", ctx, cache)

    with torch.inference_mode():
        cache = tf.block_cache(lcfg, block, B, P + steps, torch.float32,
                               device="cuda")
        zero_counts()
        y = sublayer(P, cache)
        by_body = {b: n for b, n in flash_attention.launches_by_body.items()
                   if n}
        check(by_body == {"wgmma": 1} and dict(
            flash_attention.launches_by_window) == {lcfg.window: 1},
              f"{cfg.name} local layer: bodies {by_body}, windows "
              f"{dict(flash_attention.launches_by_window)}")
        y_plain32 = sublayer(P, attn=functools.partial(_plain, f32=True))
        check(bool(torch.isfinite(y).all()), f"{cfg.name}: local layer")
        err, bound = _bound(y_plain32, y)
        emit("family_logits", arch=cfg.name, layer=block, dtype="bfloat16",
             window=lcfg.window, prompt_len=P,
             check="local_layer_prefill_kernel_vs_plain_f32_probs",
             max_abs_err=err, bound=bound,
             kernel_vs_plain=_bound(sublayer(P, attn=_plain), y)[0])
        check(err < bound, f"{cfg.name} local layer prefill: {err} >= "
              f"{bound}")
        errs, bounds = [], []
        for i in range(steps):
            pos = P + i
            at = torch.tensor(pos, device="cuda")
            ctx = tf.Ctx(cfg=lcfg, mode="decode", pos=at,
                         positions=at.view(1))
            y_dec = tf.attn_sublayer(p, x[:, pos:pos + 1], "local", ctx,
                                     cache)
            err, bound = _bound(sublayer(pos + 1)[:, -1:], y_dec)
            errs.append(err)
            bounds.append(bound)
        emit("family_logits", arch=cfg.name, layer=block, dtype="bfloat16",
             check="local_layer_decode_vs_fresh_prefill",
             positions=[P, P + steps - 1], max_abs_err=errs, bound=bounds)
        check(all(e < b for e, b in zip(errs, bounds)),
              f"{cfg.name} local layer decode: {errs} against {bounds}")
    del model, cache
    torch.cuda.empty_cache()


def _encdec_attention_check(cfg, seed: int, B: int, P: int,
                            steps: int) -> int:
    """whisper-base at full width, bf16, held on its attention outputs
    (before the output projection), where the kernel is the whole
    signal. Every flash launch of a prefill against the plain
    version with f32 probabilities on the launch's own q, k, v: the
    encoder's (not causal, over the 1500 frames) and the decoder's
    (causal) at the prompt and at each fresh prefill of prompt + the
    tokens generated so far (P + 1 .. P + steps keys). Each decode step's
    self-attention over the cache (the decode-attention kernel) against
    the last row of the
    kernel's decoder launch at that step's fresh prefill. Bound as in
    phase logits. Beside each fresh prefill, not held: its logits through
    the kernel and the bf16-probability plain version against the
    f32-probability one, the witness that rounding the probabilities alone
    moves this random-init model's logits past the bound (PERF.md).
    Returns the decode-attention kernel's calls in the decode steps, one a
    step (the decoder's one layer), each launched from the host."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import attention
    from repro_torch.models import transformer
    from repro_torch.models.zoo import build
    model = build(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    prompts = np.random.default_rng(seed + 1).integers(0, cfg.vocab, (B, P))
    frames = torch.as_tensor(_frames(cfg, B, np.random.default_rng(seed + 4)),
                             device="cuda")
    plain32 = functools.partial(_plain, f32=True)
    launched, decoded = [], []

    def spy(q, k, v, **kw):
        out = attention(q, k, v, **kw)
        err, bound = _bound(plain32(q, k, v, **kw), out)
        launched.append(dict(causal=kw["causal"], err=err, bound=bound,
                             out=out))
        return out

    def cache_spy(q, k, v, *args, **kw):
        # the decoder's self-attention over the cache
        # (transformer.decode_attention; the cross-attention is encdec's)
        out = cache_attention(q, k, v, *args, **kw)
        decoded.append(out)
        return out

    def prefill(toks, attn=spy):
        launched.clear()
        cache = model.init_cache(B, P + steps, dtype=torch.float32)
        with model_attention(attn):
            lg, cache = model.prefill({"tokens": toks, "frames": frames},
                                      cache)
        return lg, cache

    def held():
        check([c["causal"] for c in launched] == [False, True],
              f"{cfg.name}: prefill launches {launched}")
        rows.append([[c["err"], c["bound"]] for c in launched])

    rows, dec_errs, dec_bounds = [], [], []
    cache_attention = transformer.cache_attention
    with torch.inference_mode():
        toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
        lg, cache = prefill(toks)
        held()
        gen = [lg.argmax(-1)[:, None]]
        calls0 = (decode_kernel_calls(), decode_attention.launches)
        for i in range(steps):
            decoded.clear()
            transformer.cache_attention = cache_spy
            try:
                lg_dec, cache = model.decode_step(cache, gen[-1])
            finally:
                transformer.cache_attention = cache_attention
            check(bool(torch.isfinite(lg_dec).all()) and len(decoded) == 1,
                  f"{cfg.name}: decode step {i}")
            seq = torch.cat([toks, *gen], dim=1)     # its last row: P + i
            lg_k = prefill(seq)[0]
            held()
            err, bound = _bound(launched[1]["out"][:, -1:], decoded[0])
            dec_errs.append(err)
            dec_bounds.append(bound)
            lg32 = prefill(seq, plain32)[0]
            emit("family_logits", arch=cfg.name, dtype="bfloat16",
                 diagnostic="logits_witness", prompt_len=seq.shape[1],
                 bound=_bound(lg32, lg_k)[1],
                 kernel_vs_plain_f32_probs=_bound(lg32, lg_k)[0],
                 plain_vs_plain_f32_probs=_bound(
                     lg32, prefill(seq, _plain)[0])[0],
                 decode_vs_plain_f32_probs=_bound(lg32, lg_dec)[0])
            gen.append(lg_dec.argmax(-1)[:, None])
    calls = decode_kernel_calls() - calls0[0]
    check(calls == decode_attention.launches - calls0[1]
          == cache_attending(cfg) * steps,
          f"{cfg.name}: decode-attention kernel called {calls} times, "
          f"launched {decode_attention.launches - calls0[1]}, expected "
          f"{cache_attending(cfg)} layers x {steps} steps")
    emit("family_logits", arch=cfg.name, n_layers=cfg.n_layers,
         encoder_layers=cfg.encoder.n_layers, dtype="bfloat16",
         check="attention_kernel_vs_plain_f32_probs",
         prompt_lens=[P, P + steps],
         launches="[encoder not causal, decoder causal] a prefill",
         max_abs_err_bound=rows)
    check(all(e < b for row in rows for e, b in row),
          f"{cfg.name}: attention launches against the plain version: "
          f"{rows}")
    emit("family_logits", arch=cfg.name, dtype="bfloat16",
         check="decode_attention_vs_fresh_prefill",
         positions=[P, P + steps - 1], max_abs_err=dec_errs,
         bound=dec_bounds)
    check(all(e < b for e, b in zip(dec_errs, dec_bounds)),
          f"{cfg.name} decode attention: {dec_errs} against {dec_bounds}")
    del model, cache
    torch.cuda.empty_cache()
    return calls


WKV_W0 = -5.0     # the decay bias of phase families' route check


def _wkv_routes(cfg, seed: int, B: int, P: int) -> None:
    """rwkv6-7b at full width and one layer: the prefill's logits and
    recurrent states through the chunked WKV against the loop over time on
    the same weights (the reference's two routes), bound as in phase
    logits. The decay bias ``w0`` is set to WKV_W0, so that a chunk's
    cumulative decay stays above the chunked form's e^-60 clamp: at the
    reference's init (w0 = 0, decays near e^-1 a step) it falls below it
    and the reference's chunked form itself leaves the loop behind
    (ROADMAP.md, faults of the reference)."""
    from repro_torch.models.zoo import build
    prompts = np.random.default_rng(seed + 2).integers(0, cfg.vocab, (B, P))
    toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    got = {}
    for chunked in (False, True):
        model = build(cfg.scaled(rwkv_chunked=chunked), device="cuda",
                      dtype=torch.bfloat16, seed=seed)
        model.get_parameter("segments.0.b0.0.tm.w0").fill_(WKV_W0)
        with torch.inference_mode():
            got[chunked] = model.prefill(
                {"tokens": toks}, model.init_cache(B, P, torch.float32))
        del model
    (lg, cache), (lg_c, cache_c) = got[False], got[True]
    err, bound = _bound(lg, lg_c)
    S, S_c = (c["segments"][0]["b0"]["S"] for c in (cache, cache_c))
    s_err, s_bound = _bound(S, S_c)
    emit("family_logits", arch=cfg.name, n_layers=cfg.n_layers,
         prompt_len=P, check="prefill_wkv_chunked_vs_scan", w0=WKV_W0,
         max_abs_err=err, bound=bound, state_max_abs_err=s_err,
         state_bound=s_bound)
    check(bool(torch.isfinite(lg_c).all()) and err < bound and
          s_err < s_bound, f"{cfg.name}: chunked WKV vs the loop: logits "
          f"{err} (bound {bound}), state {s_err} (bound {s_bound})")
    torch.cuda.empty_cache()


def phase_families(seed: int) -> dict:
    """The block families served at full width: gemma3-12b,
    deepseek-moe-16b, starcoder2-15b, minicpm3-4b (MLA),
    recurrentgemma-9b (RG-LRU and local attention), rwkv6-7b (twice:
    the loop over time, then the chunked WKV) and whisper-base (the
    encoder-decoder) at full depth,
    mixtral-8x22b on 2 of its 56 layers; then the one-repeat logit checks
    (gemma3-12b at 6 layers with a prompt past its window,
    deepseek-moe-16b at a dense and a MoE layer with capacity for every
    pair, so that decode and prefill drop nothing; minicpm3-4b at one
    layer; recurrentgemma-9b at one pattern of 3 layers with a prompt past
    its window, at f32, and its local layer alone at bf16; rwkv6-7b at one
    layer, and its two WKV routes against each other; whisper-base at one
    encoder and one decoder layer over 1500 frames, its logits at f32 and
    its attention outputs at bf16).
    Returns the flash launches of each main path, and the decode-attention
    kernel's calls of each and of whisper-base's attention check."""
    import repro_torch.configs as configs
    launches, decode_calls, host_s = {}, {}, {}
    for run in FAMILY_RUNS:
        t0 = time.perf_counter()
        label = _family_label(run)
        launches[label], decode_calls[label] = _serve_family(seed, run)
        host_s[label] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gemma = configs.get("gemma3_12b")
    (blocks, _), = gemma.segments
    _family_logits(gemma.scaled(compute_dtype="bfloat16",
                                segments=((blocks, 1),)),
                   seed, B=2, P=1100, steps=8)
    deepseek = configs.get("deepseek_moe_16b")
    _family_logits(deepseek.scaled(
        compute_dtype="bfloat16",
        capacity_factor=deepseek.n_experts / deepseek.top_k,
        segments=((("full:swiglu",), 1), (("full:moe",), 1))),
        seed, B=2, P=512, steps=8)
    minicpm = configs.get("minicpm3_4b")
    _family_logits(minicpm.scaled(compute_dtype="bfloat16",
                                  segments=((("mla:swiglu",), 1),)),
                   seed, B=2, P=512, steps=8)
    # recurrentgemma-9b: the pattern at f32 (its local layer's flash in
    # `simt`: one bf16 pattern amplifies rounding past the bound, PERF.md),
    # and the local layer alone at bf16 (in `wgmma`, as served)
    rg = configs.get("recurrentgemma_9b")
    _family_logits(rg.scaled(compute_dtype="float32",
                             segments=((rg.segments[0][0], 1),)),
                   seed, B=2, P=rg.window + 52, steps=8, dtype=torch.float32)
    _local_layer_check(rg, seed, B=2, P=rg.window + 52, steps=8)
    rwkv = configs.get("rwkv6_7b").scaled(compute_dtype="bfloat16",
                                          segments=((("rwkv:none",), 1),))
    _family_logits(rwkv, seed, B=2, P=512, steps=8)
    _wkv_routes(rwkv, seed, B=2, P=512)
    # whisper-base at one encoder and one decoder layer, over the encoder's
    # 1500 frames: the logits at f32 (flash in `simt`), and at bf16 (in
    # `wgmma`) the attention outputs. At bf16, rounding the probabilities
    # alone moves its logits past the bound, at full depth and at one
    # layer (PERF.md; the served model's full-depth readings are phase
    # families' `depth_witness` line, one layer's the `logits_witness`).
    whisper = configs.get("whisper_base")
    one = whisper.scaled(segments=((whisper.segments[0][0], 1),),
                         encoder=dataclasses.replace(whisper.encoder,
                                                     n_layers=1))
    _family_logits(one.scaled(compute_dtype="float32"), seed, B=2, P=64,
                   steps=8, dtype=torch.float32)
    decode_calls["whisper_base_attention_check"] = _encdec_attention_check(
        one.scaled(compute_dtype="bfloat16"), seed, B=2, P=64, steps=8)
    host_s["logit_checks"] = time.perf_counter() - t0
    emit("families", host_s=host_s)
    return launches, decode_calls


FILTER_CS = (1, 2, 4, 8)
FILTER_NS = (1, 2047, 2049, 1_000_003, 2**22)
FILTER_SPECIALS = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45,
                            -1e-45, 1e-40, -1e-40, 1.1754942e-38], np.float32)


def _filter_bounds(rng, C, kind):
    """Per-column [lo, hi]: "gt0" is C("x") > 0 in column 0 (lo = 1e-45, a
    subnormal), "inf" has unbounded sides, "empty" has lo > hi."""
    lo = rng.uniform(-1.5, 0.0, C).astype(np.float32)
    hi = rng.uniform(0.0, 1.5, C).astype(np.float32)
    if kind == "gt0":
        lo[0], hi[0] = np.float32(1e-45), np.inf
    elif kind == "inf":
        lo[::2], hi[1::2] = -np.inf, np.inf
    elif kind == "empty":
        lo[-1], hi[-1] = 1.0, -1.0
    return lo, hi


def phase_filter_kernels(seed: int) -> int:
    """The range filter on the card against its plain version, on the card
    and on the CPU, bit for bit; returns the number of mismatched rows."""
    from repro_torch.kernels.filter import range_mask, range_mask_ref
    rng = np.random.default_rng(seed)
    mismatches, case, cases = 0, 0, []
    for N in FILTER_NS:
        x = rng.standard_normal((max(FILTER_CS), N), dtype=np.float32)
        hit = rng.random((max(FILTER_CS), N)) < 0.05
        x[hit] = rng.choice(FILTER_SPECIALS, int(hit.sum()))
        x_cpu = torch.from_numpy(x)
        x_dev = x_cpu.to("cuda")
        views = [("contiguous", C, x_dev[:C], x_cpu[:C]) for C in FILTER_CS]
        if N > 4:
            views += [("every_other_column", 4, x_dev[::2], x_cpu[::2]),
                      ("every_other_row", 4, x_dev[:4, 1::2], x_cpu[:4, 1::2]),
                      ("offset_by_3", 8, x_dev[:, 3:], x_cpu[:, 3:])]
        for layout, C, xd, xc in views:
            for kind in ("gt0", "inf", "empty"):
                lo, hi = _filter_bounds(rng, C, kind)
                lo_c, hi_c = torch.from_numpy(lo), torch.from_numpy(hi)
                lo_d, hi_d = lo_c.to("cuda"), hi_c.to("cuda")
                got = range_mask(xd, lo_d, hi_d)
                plain_dev = range_mask_ref(xd, lo_d, hi_d)
                plain_cpu = range_mask_ref(xc, lo_c, hi_c)
                torch.cuda.synchronize()
                got_c = got.cpu()
                bad = int((got_c != plain_cpu).sum())
                bad_dev = int((got != plain_dev).sum())
                cases.append([C, xd.shape[1], layout, kind,
                              int(got_c.sum())])
                check(bad == 0 and bad_dev == 0,
                      f"filter case {case} {cases[-1]} strides "
                      f"{xd.stride()}: {bad} rows differ from the plain "
                      f"version on the CPU, {bad_dev} on the card")
                check(kind != "empty" or not bool(got_c.any()),
                      f"filter case {case}: an empty interval kept rows")
                mismatches += bad
                case += 1
    emit("filter_kernels", cases=case, mismatches=mismatches,
         compared_with=["range_mask_ref on the card", "range_mask_ref on the CPU"],
         case_list="[C, N, layout, bounds, rows_kept]", results=cases)
    return mismatches


DEQUANT_CODES = (np.int8, np.uint8, np.int16, np.uint16)
DEQUANT_SHAPES = ((512, 256), (2**20, 1), (130, 70), "transposed_strided")


def _dequant_numpy(q, scale, zero, out_dtype):
    """The dequant function in NumPy on the CPU: separate multiply and add
    in the type of scale/zero, bf16 bits reinterpreted, bfloat16 output
    rounded as the storage layer rounds (``quantize`` to BF16)."""
    from repro_torch.core.quantization import QuantMode, QuantSpec, quantize
    if q.dtype == np.uint16:
        f = (q.astype(np.uint32) << np.uint32(16)).view(np.float32)
    else:
        f = (q.astype(scale.dtype) * scale + zero).astype(np.float32)
    if out_dtype == torch.bfloat16:
        return quantize(f, QuantSpec(QuantMode.BF16))
    return f


def _same_bits(got, plain, want, what: str) -> float:
    """The kernel's output against its plain version on the card and the
    NumPy version, bit for bit; returns the largest difference from the
    plain version over finite values (0 when the bits agree)."""
    iv, nv = ((torch.int32, np.uint32) if got.dtype == torch.float32
              else (torch.int16, np.uint16))
    torch.cuda.synchronize()
    bad_dev = int((got.view(iv) != plain.view(iv)).sum())
    got_np = got.view(iv).cpu().numpy().view(nv)
    bad_cpu = int((got_np != np.asarray(want).view(nv)).sum())
    check(bad_dev == 0 and bad_cpu == 0,
          f"{what}: {bad_dev} values differ from the plain version on the "
          f"card, {bad_cpu} from NumPy on the CPU")
    g, p = got.float(), plain.float()
    fin = torch.isfinite(g) & torch.isfinite(p)
    return (g[fin] - p[fin]).abs().max().item() if bool(fin.any()) else 0.0


def phase_dequant_kernels(seed: int) -> float:
    """The dequant kernel against its plain version on the card and NumPy on
    the CPU, bit for bit; returns the largest difference (0.0)."""
    from repro_torch.core.quantization import (QuantMode, QuantSpec,
                                               affine_spec_for, dequantize)
    from repro_torch.kernels.dequant import dequant, dequant_ref
    rng = np.random.default_rng(seed)
    max_err, cases = 0.0, []
    for code in DEQUANT_CODES:
        info = np.iinfo(code)
        for shape in DEQUANT_SHAPES:
            if shape == "transposed_strided":      # [200, 256], strides (3, 600)
                full = rng.integers(info.min, info.max + 1, (260, 600)).astype(code)
                q_cpu = full.T[::3, 4:]
                q = torch.from_numpy(full).cuda().t()[::3, 4:]
            else:
                q_cpu = rng.integers(info.min, info.max + 1, shape).astype(code)
                q = torch.from_numpy(q_cpu).cuda()
            C = q.shape[1]
            for arith in (np.float32, np.float64):
                scale = rng.uniform(1e-3, 1.0, C).astype(arith)
                zero = rng.normal(size=C).astype(arith)
                s, z = torch.from_numpy(scale).cuda(), torch.from_numpy(zero).cuda()
                for out_dtype in (torch.float32, torch.bfloat16):
                    what = (f"dequant {np.dtype(code).name}{list(q.shape)} "
                            f"strides {q.stride()} {np.dtype(arith).name} -> "
                            f"{str(out_dtype).replace('torch.', '')}")
                    got = dequant(q, s, z, out_dtype)
                    err = _same_bits(got, dequant_ref(q, s, z, out_dtype),
                                     _dequant_numpy(q_cpu, scale, zero,
                                                    out_dtype), what)
                    max_err = max(max_err, err)
                    cases.append(what)
    # every code of each storage type through the read path's route (float64
    # scale and zero, float32 out) against the storage layer's dequantize
    n = 100_000
    columns = {"normal": rng.normal(size=n), "uniform": rng.uniform(-3, 7, n),
               "skewed": rng.lognormal(0.0, 1.5, n), "constant": np.full(n, 2.5)}
    specs = [(m, name, affine_spec_for(x, m)) for m in (
        QuantMode.INT8_AFFINE, QuantMode.UINT8_AFFINE, QuantMode.INT16_AFFINE)
        for name, x in columns.items()]
    specs.append((QuantMode.BF16, "all_patterns", QuantSpec(QuantMode.BF16)))
    every_code = []
    for mode, name, spec in specs:
        code = {QuantMode.INT8_AFFINE: np.int8, QuantMode.UINT8_AFFINE: np.uint8,
                QuantMode.INT16_AFFINE: np.int16, QuantMode.BF16: np.uint16}[mode]
        info = np.iinfo(code)
        codes = np.arange(info.min, info.max + 1).astype(code)
        q = torch.from_numpy(codes).cuda().view(-1, 1)
        params = torch.tensor([spec.scale, spec.zero], dtype=torch.float64,
                              device="cuda")
        got = dequant(q, params[:1], params[1:], torch.float32)
        plain = dequant_ref(q, params[:1], params[1:], torch.float32)
        max_err = max(max_err, _same_bits(
            got, plain, dequantize(codes, spec).reshape(-1, 1),
            f"every code of {mode.name} ({name} column)"))
        every_code.append([mode.name, name, len(codes), spec.scale, spec.zero])
    groups = _dequant_column_kernels(rng)
    emit("dequant_kernels", cases=len(cases), mismatches=0, max_abs_err=max_err,
         compared_with=["dequant_ref on the card", "NumPy on the CPU"],
         every_code_vs_dequantize=every_code,
         every_code_list="[mode, column, codes, scale, zero]",
         column_list_groups=groups,
         column_list_compared_with=["dequant_packed_ref on the card",
                                    "dequantize (NumPy) on the CPU"],
         group_list="[layout, columns, rows, tiles, launches]")
    return max_err


DEQUANT_CODE_MODES = ("INT8_AFFINE", "UINT8_AFFINE", "INT16_AFFINE", "BF16")


def _column_group(rng, n_cols: int, max_rows: int):
    """Columns of all four code types in turn at odd lengths, column 2
    empty, each with the spec the writer would give it."""
    from repro_torch.core.quantization import (QuantMode, QuantSpec,
                                               affine_spec_for, storage_dtype)
    codes, specs = [], []
    for i in range(n_cols):
        mode = QuantMode[DEQUANT_CODE_MODES[i % 4]]
        code = storage_dtype(mode)
        info = np.iinfo(code)
        rows = 0 if i == 2 else int(rng.integers(1, max_rows)) | 1
        codes.append(rng.integers(info.min, info.max + 1, rows).astype(code))
        specs.append(QuantSpec(mode) if mode == QuantMode.BF16 else
                     affine_spec_for(rng.normal(size=1000) * (i + 1), mode))
    return codes, specs


def _unaligned_packing(codes, params):
    """A staging buffer laid out by hand as the packer never lays it out:
    codes aligned only to their size, outputs back to back from element 3.
    Returns (buffer, tiles, out offsets, n_out)."""
    from repro_torch.kernels.dequant.staging import (CODE_TYPES, DESC_DTYPE,
                                                     TILE_BYTES)
    desc = np.zeros(len(codes), DESC_DTYPE)
    pos, at, tile = desc.nbytes + 1, 3, 0
    for d, q, (scale, zero) in zip(desc, codes, params):
        pos = -(-pos // q.itemsize) * q.itemsize + 3 * q.itemsize
        d["code_offset"], d["out_offset"], d["rows"] = pos, at, len(q)
        d["tile_start"], d["scale"], d["zero"] = tile, scale, zero
        d["q_type"] = CODE_TYPES[q.dtype]
        pos, at = pos + q.nbytes, at + len(q)
        tile += -(-q.nbytes // TILE_BYTES)
    host = np.zeros(pos, np.uint8)
    host[:desc.nbytes] = desc.view(np.uint8)
    for d, q in zip(desc, codes):
        off = int(d["code_offset"])
        host[off:off + q.nbytes].view(q.dtype)[:] = q
    return (torch.from_numpy(host), tile,
            [int(o) for o in desc["out_offset"]], at)


def _dequant_column_kernels(rng) -> list:
    """The column-list body against its plain version on the card and
    NumPy ``dequantize`` on the CPU, bit for bit: through the entry point
    (``dequant_columns``, one launch a group) and through the body on the
    packer's buffer and on a buffer laid out at unaligned offsets."""
    from repro_torch.core.quantization import dequantize
    from repro_torch.kernels.dequant import (dequant_columns, dequant_packed,
                                             dequant_packed_ref, pack_columns)
    results = []
    for n_cols, max_rows in ((4, 2**20), (7, 300_001), (70, 20_001),
                             (16, 2**20)):
        codes, specs = _column_group(rng, n_cols, max_rows)
        params = [(sp.scale, sp.zero) for sp in specs]
        wants = [dequantize(q, sp).view(np.uint32)
                 for q, sp in zip(codes, specs)]
        before = dequant_packed.launches
        got = dequant_columns(codes, params, device="cuda")
        launches = dequant_packed.launches - before
        check(launches == 1, f"dequant_columns of {n_cols} columns launched "
              f"{launches} times")
        packed = pack_columns(codes, params)
        layouts = [("packed", packed.buffer, packed.n_tiles,
                    packed.out_offsets, packed.n_out),
                   ("unaligned", *_unaligned_packing(codes, params))]
        for layout, host, tiles, offsets, n_out in layouts:
            staging = host.cuda()
            out = dequant_packed(staging, n_cols, tiles, n_out)
            plain = dequant_packed_ref(staging, n_cols, n_out)
            torch.cuda.synchronize()
            out_np, plain_np = (t.view(torch.int32).cpu().numpy().view(np.uint32)
                                for t in (out, plain))
            for i, (q, at, want) in enumerate(zip(codes, offsets, wants)):
                what = (f"dequant column list ({layout}) column {i} of "
                        f"{n_cols}: {q.dtype}[{len(q)}]")
                check(np.array_equal(out_np[at:at + len(q)], want)
                      and np.array_equal(plain_np[at:at + len(q)], want),
                      f"{what}: differs from the plain version or NumPy")
                if layout == "packed":
                    check(np.array_equal(got[i].numpy().view(np.uint32), want),
                          f"{what}: dequant_columns differs from NumPy")
            results.append([layout, n_cols, sum(len(q) for q in codes), tiles,
                            launches if layout == "packed" else 1])
    return results


BITUNPACK_NS = (1, 31, 32, 8192, 8192 + 7 * 32, 2**24)
BITUNPACK_MAIN = dict(n=2**24, width=11)


def _bitunpack_numpy(planes: np.ndarray, width: int) -> np.ndarray:
    """The BP32 unpack in NumPy: uint32[G, w] -> uint32[G*32]."""
    out = np.zeros((planes.shape[0], 32), np.uint32)
    lanes = np.arange(32, dtype=np.uint32)
    for j in range(width):
        out |= ((planes[:, j:j + 1] >> lanes) & np.uint32(1)) << np.uint32(j)
    return out.reshape(-1)


def phase_bitunpack_kernels(seed: int) -> tuple[int, float]:
    """The BP32 entry point once (``pack_bp32`` on the host, ``bitunpack``
    on the card) with its launch count; then the kernel against its plain
    version on the card and NumPy on the CPU, exactly. Returns the main
    path's launches and the mismatches (0)."""
    from repro_torch.kernels.bitunpack import (bitunpack, bitunpack_ref,
                                               pack_bp32)
    rng = np.random.default_rng(seed)
    n, w = BITUNPACK_MAIN["n"], BITUNPACK_MAIN["width"]
    values = rng.integers(0, 2**w, n, dtype=np.uint64).astype(np.uint32)
    planes = pack_bp32(values, w)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = bitunpack(planes, w, n)                               # the main path
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launched = counts()
    check(launched == dict(flash_attention=0, range_mask=0, dequant=0,
                           dequant_packed=0, bitunpack=1, page_unpack=0),
          f"bitunpack path launched {launched}")
    check(np.array_equal(out.cpu().numpy(), values),
          "bitunpack of pack_bp32 differs from the values packed")
    emit("bitunpack_kernels", main_path="pack_bp32 -> bitunpack", n=n,
         width=w, planes=list(planes.shape), launches=launched["bitunpack"],
         wall_ms=wall_s * 1e3, equal_to_values=True)

    # 2**24 values: random plane words, every other width as a strided view
    big = rng.integers(0, 2**32, (2**24 // 32, 32), dtype=np.uint64) \
        .astype(np.uint32)
    big_dev = torch.from_numpy(big).cuda()
    numpy_big_widths = (1, 11, 32)     # NumPy at 2**24 takes ~0.1 s a plane
    cases = 0
    for w in range(1, 33):
        for n in BITUNPACK_NS:
            if n < 2**24:
                values = rng.integers(0, 2**w, n, dtype=np.uint64) \
                    .astype(np.uint32)
                planes = pack_bp32(values, w)
                pd = torch.from_numpy(planes).cuda()
                if w % 2:                         # odd widths: a strided view
                    wide = torch.zeros((planes.shape[0], 34),
                                       dtype=torch.uint32, device="cuda")
                    wide[:, 2:2 + w] = pd
                    pd = wide[:, 2:2 + w]
                want = _bitunpack_numpy(planes, w)[:n]
                check(np.array_equal(want, values), f"NumPy unpack w={w} n={n}")
            else:
                pd = big_dev[:, :w] if w % 2 == 0 else big_dev[:, :w].contiguous()
                want = (_bitunpack_numpy(big[:, :w], w)[:n]
                        if w in numpy_big_widths else None)
            got = bitunpack(pd, w, n)
            plain = bitunpack_ref(pd, w)[:n]
            torch.cuda.synchronize()
            bad_dev = int((got.view(torch.int32) != plain.view(torch.int32)).sum())
            bad_cpu = (0 if want is None
                       else int((got.cpu().numpy() != want).sum()))
            check(bad_dev == 0 and bad_cpu == 0,
                  f"bitunpack w={w} n={n} strides {pd.stride()}: {bad_dev} "
                  f"values differ from the plain version on the card, "
                  f"{bad_cpu} from NumPy")
            cases += 1
    emit("bitunpack_kernels", cases=cases, widths="1-32",
         n=list(BITUNPACK_NS), mismatches=0,
         compared_with=["bitunpack_ref on the card",
                        "NumPy on the CPU (n < 2**24: every width; n = 2**24: "
                        f"widths {list(numpy_big_widths)})"],
         strided_views="odd widths below 2**24, even widths at 2**24")
    return launched["bitunpack"], 0.0


ADS = dict(n_rows=2**22, n_sparse=0, n_dense=16, rows_per_group=2**20)
ADS_COLUMNS = ["user_id", "ts", *(f"dense_{i}" for i in range(16)), "label"]
LM_COLUMNS = ["doc_id", "tokens", "quality", "n_tokens"]
QUANT = dict(n_rows=2**22, rows_per_group=2**20)
QUANT_COLUMNS = ["id", "q_i8", "q_u8", "q_i16", "q_bf16", "q_fp8", "q_fp16"]


def _scan_queries():
    """(query, table, columns, predicate, dequantized, dequant launches per
    scan: one column-list launch for each decode call that has a BF16 or
    affine column). The ads scan dequantizes its 4 BF16 predicate columns
    in one launch and its 12 BF16 payload columns in another, in each of 4
    row groups; the quantized table its INT8 and INT16 predicate columns in
    one and, dequantized, its UINT8 and BF16 payload columns in another
    (FP8 and FP16 stay in NumPy), raw only the predicate's; the LM corpus
    has no quantized column."""
    from repro_torch.scan import C
    ads_pred = ((C("dense_0") > 0) & (C("dense_1") <= 1.0)
                & (C("dense_2") >= -1.0) & (C("dense_3") < 0.5))
    quant_pred = (C("q_i8") > -0.5) & (C("q_i16") <= 2.0)
    return [("ads", "ads", ADS_COLUMNS, ads_pred, True, 8),
            ("lm_corpus", "lm_corpus", LM_COLUMNS, C("quality") >= 0.5, True, 0),
            ("quant", "quant", QUANT_COLUMNS, quant_pred, True, 8),
            ("quant_raw", "quant", QUANT_COLUMNS, quant_pred, False, 4)]


def _same_table(a: dict, b: dict) -> bool:
    if list(a) != list(b):
        return False
    for k in a:
        if isinstance(a[k], np.ndarray):
            if not (isinstance(b[k], np.ndarray) and a[k].dtype == b[k].dtype
                    and np.array_equal(a[k].view(np.uint8),
                                       b[k].view(np.uint8))):
                return False
        elif len(a[k]) != len(b[k]) or not all(
                np.array_equal(x, y) for x, y in zip(a[k], b[k])):
            return False
    return True


def _device_split(prof) -> dict:
    """Device ms of the copies (page-locked and pageable host memory apart)
    and of the kernels in one profiled scan. The call counts are the
    profiler's records, which lose a few (see ``_device_us``); the launch
    counts of the wrappers are the check."""
    from torch.autograd import DeviceType
    split = {"h2d_ms": 0.0, "d2h_ms": 0.0, "h2d_pinned_ms": 0.0,
             "d2h_pinned_ms": 0.0, "filter_kernel_ms": 0.0,
             "dequant_kernel_ms": 0.0, "unpack_kernel_ms": 0.0,
             "other_ms": 0.0}
    calls = {"filter_kernel": 0, "dequant_kernel": 0, "unpack_kernel": 0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        key = ("h2d" if "HtoD" in e.key else "d2h" if "DtoH" in e.key
               else "filter_kernel" if "range_mask" in e.key
               else "dequant_kernel" if "dequant" in e.key
               else "unpack_kernel" if "page_unpack" in e.key else "other")
        split[key + "_ms"] += ms
        if key in ("h2d", "d2h") and "Pinned" in e.key:
            split[key + "_pinned_ms"] += ms
        if key in calls:
            calls[key] += e.count
    return {**split, "kernel_calls": calls}


def phase_scan(seed: int, tmp: str) -> dict:
    """The predicate read path on three tables written by the port's writer
    into ``tmp`` (where the later phases find them); returns the launches
    of each kernel in the ads table's serial scan."""
    from repro_torch.data import (write_ads_table, write_lm_corpus,
                                  write_quant_table)
    from repro_torch.dataset import dataset
    from repro_torch.obs import trace
    from torch.profiler import ProfilerActivity, profile

    main_launches = None
    paths = scan_paths(tmp)
    for name, path in paths.items():
        t0 = time.perf_counter()
        if name == "ads":
            write_ads_table(path, seed=seed, **ADS)
        elif name == "quant":
            write_quant_table(path, seed=seed, **QUANT)
        else:
            write_lm_corpus(path, seed=seed)
        emit("scan", table=name, write_s=time.perf_counter() - t0,
             file_bytes=os.path.getsize(path),
             config={"ads": ADS, "quant": QUANT}.get(
                 name, "write_lm_corpus defaults"),
             reduced=["n_sparse 32 -> 0"] if name == "ads" else [])

    for query, table, cols, pred, dequantized, want_dq in _scan_queries():
        path = paths[table]
        ds = dataset(path, device="cuda").select(cols).where(pred) \
            .dequantized(dequantized)
        groups = _evaluated_groups(ds)
        ds.to_table()                                  # warm-up
        runs = {}
        for label, kw in (("serial", {}),
                          ("parallel", dict(parallelism=4, io_depth=2))):
            zero_counts()
            with decode_calls() as calls:
                got = ds.to_table(**kw)                 # the main path
            launched = counts()
            check(launched == dict(flash_attention=0, range_mask=groups,
                                   dequant=0, dequant_packed=want_dq,
                                   bitunpack=0, page_unpack=calls["unpack"]),
                  f"{query} {label}: launched {launched}, expected the "
                  f"filter once for each of {groups} evaluated row "
                  f"groups, the column-list dequant {want_dq} times and "
                  f"the page unpack once for each decode call that routes "
                  f"a page or dequantizes ({calls})")
            # every dequantizing call launches the unpack; each of the ads
            # scan's calls has a BF16 column
            check(calls["unpack"] >= want_dq and (
                query != "ads" or calls["unpack"] == want_dq),
                  f"{query} {label}: {calls} against {want_dq} dequant "
                  "launches")
            runs[label] = (got, launched)
            if query == "ads" and label == "serial":
                main_launches = launched
        plain = dataset(path, device="cuda").select(cols).where(pred) \
            .dequantized(dequantized)._with_kernel(False)
        want, want_ids = plain.to_table(), plain.row_ids()
        n_out = len(want_ids)
        check(0 < n_out < ds.num_rows, f"{query}: {n_out} rows kept")
        check(np.array_equal(ds.row_ids(), want_ids),
              f"{query}: row ids differ from the NumPy route")
        for label, (got, _) in runs.items():
            check(_same_table(got, want),
                  f"{query} {label}: columns differ from the NumPy route")
            check(all(len(v) == n_out for v in got.values()),
                  f"{query} {label}: column lengths")

        size = os.path.getsize(path)
        times = {}
        for label, kw in (("serial", {}),
                          ("parallel", dict(parallelism=4, io_depth=2))):
            samples = []
            for _ in range(5):
                t0 = time.perf_counter()
                ds.to_table(**kw)
                samples.append(time.perf_counter() - t0)
            times[label] = float(np.median(samples))
        with trace.collect() as tracer:
            t0 = time.perf_counter()
            ds.to_table()
            traced_s = time.perf_counter() - t0
        stages = {k: {"calls": a.count, "ms": a.seconds * 1e3}
                  for k, a in sorted(tracer.aggregate().items())}
        # decode ms by column; dequantize ms by call, keyed by its route
        # and its column list
        by_column: dict = {}
        for rec in tracer.spans:
            if rec.name == "decode.decode":
                key = f"decode:{rec.args.get('column')}"
            elif rec.name == "decode.dequantize":
                key = (f"dequantize:{rec.args.get('route')}:"
                       + "+".join(rec.args.get("columns", ())))
            else:
                continue
            by_column[key] = by_column.get(key, 0.0) + rec.dur * 1e3
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            ds.to_table()
            profiled_s = time.perf_counter() - t0
        emit("scan", query=query, table=table, columns=len(cols),
             predicate=repr(pred), dequantized=dequantized,
             rows=ds.num_rows, rows_out=n_out, row_groups=groups,
             launches_serial=runs["serial"][1],
             launches_parallel=runs["parallel"][1], decode_calls=calls,
             equal_to_numpy_route=True,
             scan_ms=times["serial"] * 1e3,
             rows_per_s=ds.num_rows / times["serial"],
             file_bytes_per_s=size / times["serial"],
             scan_ms_parallel4_io2=times["parallel"] * 1e3,
             rows_per_s_parallel4_io2=ds.num_rows / times["parallel"],
             file_bytes_per_s_parallel4_io2=size / times["parallel"],
             traced_ms=traced_s * 1e3, host_stages=stages,
             host_ms_by_column=by_column,
             profiled_ms=profiled_s * 1e3, device=_device_split(prof))
    return main_launches


PAGE_UNPACK_ROWS = 2**19       # one row group of the benchmark's table


def phase_page_unpack(seed: int) -> dict:
    """The benchmark's ``ads-criteo`` table (``perfbench/configs``, its
    generator and its LEVEL2 delete) at one row group of 2**19 rows, read
    whole on the card, dequantized, as the ``ads-scan`` cell reads it: one
    decode call, one unpack and one dequant launch, pages on the device
    route, the table equal to the NumPy route's. Then that call's unpack
    staging, replayed through the wrapper (``page_unpack``, counted) into
    a zeroed buffer, against ``page_unpack_ref`` on the card on the same
    staging, bit for bit; the kernel's device time (``median_ms``) beside
    its bound (``Layout.moved_bytes`` at 3.35 TB/s), the plain version's
    (CUDA events, one call) and the host's NumPy decode of the same
    device-route pages (``decode_page``, then ``apply_dv``); the launch
    also carries the host-route pages of the BF16 columns, as pages of
    their codes. Returns the row of the kernels line."""
    from perfbench.lib import tables
    from repro_torch.core import pages as pages_mod
    from repro_torch.core.footer import PageType
    from repro_torch.dataset import dataset, page_route
    from repro_torch.kernels.page_unpack import page_unpack, page_unpack_ref
    from repro_torch.obs import metrics

    class _Stages:
        def mark(self, name):
            pass

    cfg = json.loads((ROOT / "perfbench/configs/ads-criteo.json").read_text())
    cfg["rows"] = PAGE_UNPACK_ROWS
    columns = json.loads((ROOT / "perfbench/traffic/scan-4pred.json")
                         .read_text())["columns"]
    table = tables.make(cfg, seed, "cuda", _Stages())
    try:
        staged, taken = [], []
        real_unpack, real_take = page_route.page_unpack, \
            page_route.DeviceDecode.take

        def unpack(staging, layout, out):
            staged.append((staging.clone(), layout, torch.zeros_like(out)))
            return real_unpack(staging, layout, out)

        def take(self, blob, page_rows, dtype, dv=None, align=False):
            page = real_take(self, blob, page_rows, dtype, dv, align)
            if page is not None:
                taken.append((blob, page_rows, dv))
            return page

        def read(device, use_kernel=None):
            with dataset(table.path, device=device) as ds:
                return ds.select(columns).dequantized(True) \
                    ._with_kernel(use_kernel).to_table()

        device_pages = metrics.counter("bullion.decode.pages_device")
        before = device_pages.value
        page_route.page_unpack, page_route.DeviceDecode.take = unpack, take
        zero_counts()
        try:
            with decode_calls() as calls:
                got = read("cuda")                          # the main path
        finally:
            page_route.page_unpack, page_route.DeviceDecode.take = \
                real_unpack, real_take
        launched = counts()
        routed = device_pages.value - before
        check(launched == dict(flash_attention=0, range_mask=0, dequant=0,
                               dequant_packed=1, bitunpack=0, page_unpack=1)
              and calls == dict(routed=1, pages=routed, unpack=1)
              and len(staged) == 1 and routed == len(taken) > 0,
              f"page_unpack: one group's read launched {launched}, decode "
              f"calls {calls}, {routed} pages routed")
        check(_same_table(got, read("cuda", use_kernel=False)),
              "page_unpack: the read differs from the NumPy route")
        staging, layout, out = staged[0]
        plain = torch.zeros_like(out)
        page_unpack(staging, layout, out)                   # the wrapper
        page_unpack_ref(staging, layout.n_pages, plain)
        torch.cuda.synchronize()
        check(page_unpack.launches == 2, f"page_unpack: the replay launched "
              f"{page_unpack.launches - 1} times")
        bad = int((out != plain).sum())
        check(bad == 0, f"page_unpack: {bad} bytes of the kernel's output "
              "differ from page_unpack_ref on the same staging")
        kernel_ms = median_ms(lambda: page_unpack(staging, layout, out))
        plain_ms = []
        for _ in range(3):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            page_unpack_ref(staging, layout.n_pages, plain)
            stop.record()
            stop.synchronize()
            plain_ms.append(start.elapsed_time(stop))
        scalar = int(PageType.SCALAR)
        t0 = time.perf_counter()
        for blob, page_rows, dv in taken:
            pages_mod.apply_dv(pages_mod.decode_page(scalar, blob), dv,
                               page_rows)
        numpy_ms = (time.perf_counter() - t0) * 1e3
        row = dict(rows=PAGE_UNPACK_ROWS, columns=len(columns),
                   pages=layout.n_pages, pages_routed=routed,
                   blocks=layout.n_blocks, bytes=layout.moved_bytes,
                   kernel_ms=kernel_ms,
                   bound_ms=layout.moved_bytes / HBM_BYTES_PER_S * 1e3,
                   plain_ms=float(np.median(plain_ms)),
                   numpy_ms=numpy_ms, mismatches=bad)
        emit("page_unpack", main_path="dataset(..., device='cuda')"
             ".select(22 columns).dequantized().to_table()",
             launches=launched, equal_to_numpy_route=True,
             equal_to_plain_on_card=True, **row)
        return row
    finally:
        table.remove()


SERVICE_SESSIONS, SERVICE_QUERIES = 4, 25     # client sessions, queries each
SERVICE_HEAD = 2**16          # the narrow projection: a batch of 64 Ki rows


def _service_queries(C, users) -> list:
    """One session's 25 queries, the feature-serving mix on the ads table,
    repeating [range, projection, probe, probe, probe]: the ads scan's
    four-term range predicate returning two narrow columns; a projection
    of three columns, its first SERVICE_HEAD rows; and point probes
    ``user_id == k`` of five columns, one literal each from ``users``."""
    ads_pred = _scan_queries()[0][3]
    out, it = [], iter(users)
    for j in range(SERVICE_QUERIES):
        if j % 5 == 0:
            out.append(("range", dict(columns=["user_id", "label"],
                                      where=ads_pred)))
        elif j % 5 == 1:
            out.append(("projection", dict(
                columns=["user_id", "dense_0", "dense_1"],
                head=SERVICE_HEAD)))
        else:
            out.append(("probe", dict(
                columns=["user_id", "ts", "dense_0", "dense_1", "label"],
                where=C("user_id") == int(next(it)))))
    return out


def _flip_page_byte(path: str, page: int = 0) -> None:
    from repro_torch.core.footer import read_footer
    fv, _ = read_footer(path)
    off, size = fv.page_extent(page)
    with open(path, "r+b") as f:
        f.seek(off + size // 2)
        b = f.read(1)
        f.seek(off + size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


def phase_service(seed: int, tmp: str) -> dict:
    """The dataset service on the scan's ads table: a
    ``DatasetServer(device="cuda")`` on an AF_UNIX socket, and
    SERVICE_SESSIONS client sessions at once, each sending SERVICE_QUERIES
    queries (``_service_queries``; the probes' literals from the seed).
    Each distinct query first runs alone on a server of its own, which
    gives its launches of the filter and of the column-list dequant; the
    concurrent run must launch their sum, and every reply must equal what
    an in-process ``device="cpu"`` server returns. Prints queries/s, the
    host clock's p50 and p99 latency a query, the plan cache's hits.
    Then ``python -m repro_torch.cli fsck --json`` on the table (exit 0)
    and on a copy with one page byte flipped (exit 1), and ``metrics
    --socket`` against the live server. Returns the concurrent run's
    launches."""
    import concurrent.futures
    from repro_torch.dataset import dataset
    from repro_torch.scan import C
    from repro_torch.serve import DatasetServer, ServeClient
    ads = scan_paths(tmp)["ads"]
    with dataset(ads, device="cpu") as ds:
        users = ds.select(["user_id"]).to_table()["user_id"]
    rng = np.random.default_rng(seed + 5)
    n_probes = SERVICE_QUERIES * 3 // 5
    sessions = [_service_queries(C, rng.choice(users, n_probes))
                for _ in range(SERVICE_SESSIONS)]
    kinds = [q for session in sessions for q in session]

    t0 = time.perf_counter()
    solo, want = [], []
    with DatasetServer({"ads": ads}, device="cuda") as srv, \
            DatasetServer({"ads": ads}, device="cpu") as cpu:
        for _, q in kinds:
            zero_counts()
            with decode_calls() as calls:
                srv.query("ads", **q)
            solo.append(counts())
            check(solo[-1]["page_unpack"] == calls["unpack"],
                  f"service: a query launched {solo[-1]}, its decode "
                  f"calls {calls}")
            want.append(cpu.query("ads", **q).table)
    setup_s = time.perf_counter() - t0
    expect = {k: sum(c[k] for c in solo) for k in solo[0]}
    check(expect["range_mask"] > 0 and expect["dequant_packed"] > 0
          and expect["page_unpack"] >= expect["dequant_packed"]
          and expect["flash_attention"] == expect["dequant"] ==
          expect["bitunpack"] == 0,
          f"service: the queries alone launched {expect}")

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = [sys.executable, "-m", "repro_torch.cli"]
    with DatasetServer({"ads": ads}, device="cuda") as srv:
        sock = srv.serve(os.path.join(tmp, "serve.sock"))

        def session(i):
            lat, tables = [], []
            with ServeClient(sock, timeout=600) as client:
                for _, q in sessions[i]:
                    t1 = time.perf_counter()
                    tables.append(client.query("ads", **q).table)
                    lat.append(time.perf_counter() - t1)
            return lat, tables

        zero_counts()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(SERVICE_SESSIONS) as pool:
            results = list(pool.map(session, range(SERVICE_SESSIONS)))
        wall = time.perf_counter() - t0                  # the main path
        launched = counts()
        stats = srv.stats()
        metrics = subprocess.run(cli + ["metrics", "--socket", sock],
                                 env=env, capture_output=True, text=True,
                                 timeout=300)
    lat = [x for r in results for x in r[0]]
    got = [t for r in results for t in r[1]]
    check(launched == expect, f"service: {SERVICE_SESSIONS} sessions "
          f"launched {launched}, the queries alone {expect}")
    check(len(got) == len(want) and all(
        _same_table(a, b) for a, b in zip(got, want)),
          "service: a reply differs from the device='cpu' server's")
    check(metrics.returncode == 0
          and "bullion_serve_queries" in metrics.stdout,
          f"service: metrics --socket exit {metrics.returncode}: "
          f"{metrics.stderr[-400:]}")

    # the two fscks at once, each a process of its own
    bad = os.path.join(tmp, "ads_flipped.bln")
    shutil.copyfile(ads, bad)
    _flip_page_byte(bad)
    t1 = time.perf_counter()
    procs = {name: (subprocess.Popen(cli + ["fsck", "--json", path], env=env,
                                     stdout=subprocess.PIPE, text=True), want)
             for name, path, want in (("clean", ads, 0), ("flipped", bad, 1))}
    fsck = {}
    try:
        for name, (proc, want_exit) in procs.items():
            out, _ = proc.communicate(timeout=600)
            report = json.loads(out)
            fsck[name] = dict(exit=proc.returncode, errors=report["errors"],
                              checks=sum(s["checks"]
                                         for s in report["shards"]),
                              seconds=time.perf_counter() - t1)
            check(proc.returncode == report["exit"] == want_exit,
                  f"service: fsck --json of the {name} table exited "
                  f"{proc.returncode}, expected {want_exit}")
    finally:
        for proc, _ in procs.values():
            proc.kill()
            proc.wait()
    os.remove(bad)
    by_kind = {}
    for (kind, _), c in zip(kinds, solo):
        by_kind.setdefault(kind, []).append(
            [c["range_mask"], c["dequant_packed"]])
    emit("service", table="ads", rows=int(len(users)),
         sessions=SERVICE_SESSIONS, queries=len(lat),
         mix={k: len(v) for k, v in by_kind.items()},
         queries_per_s=len(lat) / wall, wall_s=wall,
         p50_ms=float(np.percentile(lat, 50)) * 1e3,
         p99_ms=float(np.percentile(lat, 99)) * 1e3,
         p50_ms_by_kind={k: float(np.median([x for (kk, _), x in
                                             zip(kinds, lat) if kk == k]))
                         * 1e3 for k in by_kind},
         rows_by_kind={k: int(np.mean([len(next(iter(t.values())))
                                       for (kk, _), t in zip(kinds, got)
                                       if kk == k])) for k in by_kind},
         launches=launched, launches_alone_by_kind={
             k: {"range_mask": sorted({x[0] for x in v}),
                 "dequant_packed": sorted({x[1] for x in v})}
             for k, v in by_kind.items()},
         plan_cache=stats["plan_cache"], errors=stats["errors"],
         equal_to_cpu_server=True, metrics_lines=len(
             metrics.stdout.splitlines()), fsck=fsck, setup_s=setup_s)
    return launched


def scan_paths(tmp: str) -> dict:
    return {"ads": os.path.join(tmp, "ads.bln"),
            "lm_corpus": os.path.join(tmp, "lm.bln"),
            "quant": os.path.join(tmp, "quant.bln")}


def _sha256(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _evaluated_groups(ds) -> int:
    """Row groups a plan evaluates its predicate on: its tasks that kept
    pages after pruning (the filter launches once for each)."""
    return sum(1 for t in ds.physical_plan().tasks
               if t.pages is None or len(t.pages))


def _ads_victim_cases(ads: str):
    """(case, predicate, level, audit column, forbidden values, expected
    launches (filter, dequant) on the card) for phase compliance: a float32
    range over two dense features (the range filter's route, about 35 rows
    scattered over every group) at L2 and L1, and 16 users from the middle
    of the id range (the per-user case of benchmarks/bench_deletion.py;
    In over int64, the NumPy route)."""
    from repro_torch.dataset import dataset
    from repro_torch.scan import C, In
    rng_pred = (C("dense_4") >= 3.0) & (C("dense_5") >= 2.5)
    with dataset(ads, device="cuda") as ds:
        victims_ts = ds.where(rng_pred).select(["ts"]).to_table()["ts"]
        groups = _evaluated_groups(ds.where(rng_pred).drop_deleted(False))
        uid = ds.select(["user_id"]).to_table()["user_id"]
    users = np.unique(uid)
    users = users[len(users) // 2:len(users) // 2 + 16]
    return [("range_l2", rng_pred, 2, "ts", victims_ts, (groups, groups)),
            ("range_l1", rng_pred, 1, "ts", victims_ts, (groups, groups)),
            ("users_l2", In("user_id", users.tolist()), 2, "user_id", users,
             (0, 0))]


def phase_compliance(tmp: str) -> dict:
    """``delete_where`` on copies of phase scan's ads table, each delete on
    the card and again with device="cpu": the files byte-identical, the
    audit (``verify_deleted``) clean, a reopened scan short of exactly the
    deleted rows, the filter (and the dequantize of the predicate's BF16
    columns) launched once a row group evaluated. Returns the launches of
    each kernel by case and the range delete's victims (their ``ts``), and
    leaves the range-L1 copy for phase sink."""
    from repro_torch.core import Compliance, delete_where, verify_deleted
    from repro_torch.dataset import dataset
    ads = scan_paths(tmp)["ads"]
    with dataset(ads, device="cuda") as ds:
        rows_before = ds.count_rows()
    launched = {}
    cases = _ads_victim_cases(ads)
    for case, pred, level, col, forbidden, (want_f, want_dq) in cases:
        on_card = os.path.join(tmp, f"del_{case}.bln")
        on_cpu = os.path.join(tmp, f"del_{case}_cpu.bln")
        shutil.copyfile(ads, on_card)
        shutil.copyfile(ads, on_cpu)
        zero_counts()
        t0 = time.perf_counter()
        with decode_calls() as calls:
            st = delete_where(on_card, pred, Compliance(level),
                              device="cuda")
        host_s = time.perf_counter() - t0
        got = counts()
        t0 = time.perf_counter()
        st_cpu = delete_where(on_cpu, pred, Compliance(level), device="cpu")
        cpu_s = time.perf_counter() - t0
        check(got == dict(flash_attention=0, range_mask=want_f, dequant=0,
                          dequant_packed=want_dq, bitunpack=0,
                          page_unpack=calls["unpack"])
              and calls["unpack"] >= want_dq,
              f"compliance {case}: launched {got}, expected the filter "
              f"{want_f} times, the column-list dequant {want_dq} and the "
              f"page unpack once a decode call that routes or dequantizes "
              f"({calls})")
        check(st == st_cpu, f"compliance {case}: {st} != {st_cpu} (cpu)")
        check(_sha256(on_card) == _sha256(on_cpu),
              f"compliance {case}: the file differs from the cpu route's")
        os.unlink(on_cpu)
        check(st.rows_deleted > 0 and
              (col != "ts" or st.rows_deleted == len(forbidden)),
              f"compliance {case}: {st.rows_deleted} rows deleted, "
              f"{len(forbidden)} matched")
        audit = verify_deleted(on_card, col, forbidden, device="cuda")
        check(audit["visible_rows"] == 0 and
              (audit["raw_occurrences"] == 0 if level == 2
               else audit["raw_occurrences"] > 0),
              f"compliance {case}: audit {audit}")
        with dataset(on_card, device="cuda") as ds:
            rows_after = ds.count_rows()
            left = ds.where(pred).count_rows()
        check(rows_after == rows_before - st.rows_deleted and left == 0,
              f"compliance {case}: {rows_after} rows, {left} matching, "
              f"after deleting {st.rows_deleted} of {rows_before}")
        emit("compliance", case=case, predicate=repr(pred), level=level,
             stats=dataclasses.asdict(st),
             data_io_ratio=st.bytes_rewritten_data / st.bytes_full_rewrite,
             io_ratio=st.bytes_rewritten / st.bytes_full_rewrite,
             host_ms=host_s * 1e3, cpu_route_host_ms=cpu_s * 1e3,
             launches=got, audit=audit, rows_before=rows_before,
             rows_after=rows_after, identical_to_cpu_route=True)
        launched[case] = got
        if case != "range_l1":
            os.unlink(on_card)
    return launched, cases[0][4]


def _read_all(path: str) -> dict:
    from repro_torch.dataset import dataset
    with dataset(path, device="cuda") as ds:
        return ds.to_table()


def phase_sink(tmp: str, victims) -> dict:
    """``write_to`` of phase scan's ads query, dequantized, sorted by
    dense_0 into shards of 2**19 rows, on the card and with device="cpu":
    the shards byte-identical, read back equal to the scan's table sorted,
    the kernels launched by phase scan's rule. Then the sink of the range-L1
    copy of phase compliance, whose audit finds no raw occurrence."""
    from repro_torch.core import verify_deleted
    from repro_torch.dataset import dataset
    ads = scan_paths(tmp)["ads"]
    _, _, cols, pred, _, want_dq = _scan_queries()[0]
    with dataset(ads, device="cuda") as ds:
        groups = _evaluated_groups(ds.where(pred))
        want = ds.select(cols).where(pred).to_table()
    perm = np.argsort(want["dense_0"], kind="stable")
    want = {k: v[perm] for k, v in want.items()}
    outs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, f"sink_{dev}")
        zero_counts()
        t0 = time.perf_counter()
        with dataset(ads, device=dev) as ds, decode_calls() as calls:
            res = ds.where(pred).dequantized().write_to(
                out, sort_by="dense_0", shard_rows=SINK_SHARD_ROWS)
        outs[dev] = (out, res, time.perf_counter() - t0, counts())
        if dev == "cuda":
            unpack = calls["unpack"]
    out, res, host_s, got = outs["cuda"]
    check(got == dict(flash_attention=0, range_mask=groups, dequant=0,
                      dequant_packed=want_dq, bitunpack=0,
                      page_unpack=unpack) and unpack >= want_dq,
          f"sink: launched {got}, expected the filter {groups} times, the "
          f"column-list dequant {want_dq} and the page unpack {unpack}")
    check(outs["cpu"][3] == dict.fromkeys(got, 0), "sink: the cpu route "
          f"launched {outs['cpu'][3]}")
    check(dataclasses.asdict(res) | {"paths": None} ==
          dataclasses.asdict(outs["cpu"][1]) | {"paths": None},
          f"sink: {res} != {outs['cpu'][1]} (cpu)")
    check(res.rows == len(want["ts"]) and
          res.shards == -(-res.rows // SINK_SHARD_ROWS),
          f"sink: {res.rows} rows in {res.shards} shards")
    for a, b in zip(res.paths, outs["cpu"][1].paths):
        check(_sha256(a) == _sha256(b),
              f"sink: {os.path.basename(a)} differs from the cpu route's")
    check(_same_table(_read_all(out), want),
          "sink: the shards read back differ from the scan's table sorted")
    emit("sink", plan=f"where({pred!r}).dequantized()", sort_by="dense_0",
         shard_rows=SINK_SHARD_ROWS, result={k: v for k, v in
                                   dataclasses.asdict(res).items()
                                   if k != "paths"},
         host_ms=host_s * 1e3, cpu_route_host_ms=outs["cpu"][2] * 1e3,
         launches=got, identical_to_cpu_route=True)

    # the sink purges rows an L1 delete kept on disk
    deleted = os.path.join(tmp, "del_range_l1.bln")
    kept = verify_deleted(deleted, "ts", victims, device="cuda")
    out = os.path.join(tmp, "sink_purge")
    t0 = time.perf_counter()
    with dataset(deleted, device="cuda") as ds:
        res = ds.select(["user_id", "ts"]).write_to(out)
    host_s = time.perf_counter() - t0
    audits = [verify_deleted(p, "ts", victims, device="cuda")
              for p in res.paths]
    check(kept["raw_occurrences"] == len(victims) > 0 and
          all(a == {"visible_rows": 0, "raw_occurrences": 0} for a in audits),
          f"sink purge: before {kept}, after {audits}")
    emit("sink", case="purge_l1_deleted_copy", columns=["user_id", "ts"],
         rows=res.rows, raw_occurrences_before=kept["raw_occurrences"],
         audits=audits, host_ms=host_s * 1e3)
    for d in ("sink_cuda", "sink_cpu", "sink_purge"):
        shutil.rmtree(os.path.join(tmp, d))
    os.unlink(deleted)
    return got


LOADER = dict(batch_size=8, seq_len=2048, prefetch=2)
LOADER_CORPUS = dict(n_docs=8192)       # 8 Mi tokens: 128 groups of 64 rows
LOADER_BATCHES, LOADER_RESUME_AT = 96, 40   # of about 128 a rank an epoch
SINK_SHARD_ROWS = 2**19


def _take(loader, n: int) -> list:
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        loader.close()


def _same_batches(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype == np.int32 and np.array_equal(x, y) and c == d
        for (x, c), (y, d) in zip(a, b))


def phase_loader(seed: int, tmp: str) -> dict:
    """``BullionLoader(predicate=C("quality") >= 0.5)`` over an LM corpus of
    8 Mi tokens as rank 0 and rank 1 of 2, on the card against the
    device="cpu" loader; a resume from a mid-epoch cursor; the filter's
    launches while the loader's thread and a main-thread scan read at once;
    and ``quality_filtered_read`` against its cpu route."""
    from repro_torch.core import (MultimodalSample, quality_filtered_read,
                                  write_multimodal_dataset)
    from repro_torch.data import BullionLoader, LoaderState, write_lm_corpus
    from repro_torch.dataset import clear_footer_cache, dataset
    from repro_torch.scan import C
    corpus = os.path.join(tmp, "loader_corpus.bln")
    t0 = time.perf_counter()
    write_lm_corpus(corpus, seed=seed, **LOADER_CORPUS)
    write_s = time.perf_counter() - t0
    pred = C("quality") >= 0.5
    n_batches, resume_at = LOADER_BATCHES, LOADER_RESUME_AT
    tokens = n_batches * LOADER["batch_size"] * (LOADER["seq_len"] + 1)
    for rank in (0, 1):
        kw = dict(LOADER, rank=rank, world=2, predicate=pred)
        t0 = time.perf_counter()
        got = _take(BullionLoader(corpus, device="cuda", **kw), n_batches)
        card_s = time.perf_counter() - t0
        want = _take(BullionLoader(corpus, device="cpu", **kw), n_batches)
        check(_same_batches(got, want),
              f"loader rank {rank}: batches differ from the cpu loader's")
        cur = got[resume_at][1]
        state = LoaderState(cur.epoch, cur.group)
        resumed = _take(BullionLoader(corpus, device="cuda", state=state,
                                      **kw), 8)
        resumed_cpu = _take(BullionLoader(corpus, device="cpu",
                                          state=LoaderState(cur.epoch,
                                                            cur.group),
                                          **kw), 8)
        check(_same_batches(resumed, resumed_cpu),
              f"loader rank {rank}: the resumed batches differ")
        emit("loader", rank=rank, world=2, **LOADER, predicate=repr(pred),
             batches=n_batches, tokens=tokens,
             tokens_per_s=tokens / card_s, host_s=card_s,
             resumed_from=dataclasses.asdict(cur),
             equal_to_cpu_route=True, corpus=LOADER_CORPUS,
             corpus_write_s=write_s)

    # the loader's prefetch thread and a main-thread scan launch at once
    loader = BullionLoader(corpus, device="cuda", rank=0, world=2,
                           predicate=pred, **LOADER)
    reads, read_group = [], loader._read_group

    def counted(g, reader=None):
        reads.append(g)
        return read_group(g, reader)

    loader._read_group = counted
    with dataset(corpus, device="cuda").where(pred) as ds:
        scan_groups = _evaluated_groups(ds)
        want_scan = dataset(corpus, device="cpu").where(pred).to_table()
        zero_counts()
        with decode_calls() as calls:
            it = iter(loader)
            batches, scans = [], 0
            for i in range(n_batches):
                batches.append(next(it))
                if i % 24 == 0:
                    check(_same_table(ds.to_table(), want_scan),
                          "loader: a scan beside the loader's thread "
                          "differs")
                    scans += 1
            loader.close()
        got = counts()
    check(got["range_mask"] == len(reads) + scans * scan_groups and
          got["dequant_packed"] == 0 and got["page_unpack"] == calls["unpack"],
          f"loader: launched {got} while the loader read {len(reads)} groups "
          f"and {scans} scans {scan_groups} groups each, decode calls "
          f"{calls}")
    check(_same_batches(batches, _take(BullionLoader(
        corpus, device="cpu", rank=0, world=2, predicate=pred, **LOADER),
        n_batches)), "loader: batches beside a scan differ")
    emit("loader", case="thread_and_main_thread_scan",
         loader_groups_read=len(reads), scans=scans, scan_groups=scan_groups,
         launches=got)
    os.unlink(corpus)

    # quality-aware multimodal reads
    rng = np.random.default_rng(seed)
    samples = [MultimodalSample(
        text=b"caption %d" % i, quality=float(rng.random()),
        embedding=rng.normal(size=64).astype(np.float32),
        frames=rng.bytes(256), media_key=i) for i in range(4096)]
    meta = os.path.join(tmp, "mm.bln")
    write_multimodal_dataset(meta, os.path.join(tmp, "mm.media"), samples,
                             rows_per_group=256)
    for frac in (0.1, 0.5):
        # each read opens the file afresh: a cached footer, or pages already
        # verified in this process, would change its I/O counters
        clear_footer_cache()
        t0 = time.perf_counter()
        tables, io = quality_filtered_read(
            meta, ["text", "quality", "embedding"], frac, device="cuda")
        host_s = time.perf_counter() - t0
        clear_footer_cache()
        cpu_tables, cpu_io = quality_filtered_read(
            meta, ["text", "quality", "embedding"], frac, device="cpu")
        same_io = {k: v for k, v in dataclasses.asdict(io).items()
                   if k != "metadata_seconds"} == \
            {k: v for k, v in dataclasses.asdict(cpu_io).items()
             if k != "metadata_seconds"}
        check(len(tables) == len(cpu_tables) and all(
            _same_table(a, b) for a, b in zip(tables, cpu_tables)) and same_io,
            f"quality_filtered_read {frac}: differs from the cpu route")
        rows = sum(len(t["quality"]) for t in tables)
        check(rows == int(len(samples) * frac), f"{rows} rows at {frac}")
        emit("loader", case="quality_filtered_read", samples=len(samples),
             top_fraction=frac, rows=rows, host_ms=host_s * 1e3,
             bytes_read=io.bytes_read, bytes_pruned=io.bytes_pruned,
             equal_to_cpu_route=True)
    return got


def phase_export(tmp: str) -> None:
    """``Dataset.profile(path)`` over phase scan's ads query writes a Chrome
    trace with the decode and filter spans; a fresh interpreter with
    ``BULLION_TRACE`` set writes its trace at exit; the metrics snapshot
    renders as Prometheus text that parses back to the same values."""
    from repro_torch.dataset import dataset
    from repro_torch.obs import metrics, parse_prometheus_text, prometheus_text
    from repro_torch.obs.expose import sanitize_name
    paths = scan_paths(tmp)
    _, _, cols, pred, _, _ = _scan_queries()[0]
    out = os.path.join(tmp, "profile.json")
    t0 = time.perf_counter()
    with dataset(paths["ads"], device="cuda") as ds:
        prof = ds.select(cols).where(pred).profile(out)
    profile_s = time.perf_counter() - t0
    with open(out) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    need = {"exec.task", "exec.filter", "decode.pread", "decode.decode",
            "decode.dequantize"}
    check(need <= names, f"profile: spans {sorted(names)} lack "
          f"{sorted(need - names)}")
    kernel_spans = [e for e in doc["traceEvents"]
                    if e["name"] == "decode.dequantize"
                    and e["args"].get("route") == "kernel"]
    check(len(kernel_spans) == 8, f"profile: {len(kernel_spans)} kernel "
          "dequantize spans, expected 8")

    env_trace = os.path.join(tmp, "env_trace.json")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from repro_torch.dataset import dataset\n"
            "from repro_torch.scan import C\n"
            "with dataset(%r, device='cuda') as ds:\n"
            "    ds.where(C('quality') >= 0.5).to_table(io_depth=2)\n"
            % (str(ROOT / "src"), paths["lm_corpus"]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, BULLION_TRACE=env_trace))
    env_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"BULLION_TRACE run: {proc.stderr[-2000:]}")
    check("BULLION_TRACE export" not in proc.stderr,
          f"BULLION_TRACE: {proc.stderr}")
    with open(env_trace) as f:
        env_names = {e["name"] for e in json.load(f)["traceEvents"]
                     if e["ph"] == "X"}
    check({"plan.optimize", "plan.lower", "exec.task",
           "exec.filter"} <= env_names,
          f"BULLION_TRACE: spans {sorted(env_names)}")

    snap = metrics.snapshot()
    parsed = parse_prometheus_text(prometheus_text(snap))
    for name, v in snap.items():
        key = sanitize_name(name)
        if isinstance(v, dict):
            check(parsed[f"{key}_count"] == v["count"] and
                  parsed[f"{key}_sum"] == float(v["sum"]),
                  f"prometheus: {name} {v}")
        else:
            check(parsed[key] == float(v), f"prometheus: {name} {v}")
    emit("export", profile_spans=len(prof.spans), profile_dropped=prof.dropped,
         profile_bytes=os.path.getsize(out), profile_ms=profile_s * 1e3,
         span_names=sorted(names), env_trace_spans=len(env_names),
         env_trace_run_s=env_s, metrics=len(snap),
         prometheus_samples=len(parsed))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN = dict(batch=8, seq=512, steps=8, repeat_steps=4, bf16_steps=2,
             norm_depths=(1, 2, 4, 8))
TRAIN_CORPUS = dict(n_docs=64, doc_len=2048)     # the launcher's sizing
TRAIN_OPT = dict(lr=1e-3, warmup_steps=10, total_steps=100)   # launcher's
TRAIN_DEVICE = "cuda"
TRAIN_RANGES = ("attention_backward", "adamw_update")   # _train_ranges
TRAIN_LAUNCHER = ["--smoke", "--batch", "2", "--seq", "32", "--log-every",
                  "3", "--ckpt-every", "3"]


def _train_cfg(**kw):
    """llama3.2-1b at full width and depth, f32 (the launcher's compute)."""
    import repro_torch.configs as configs
    return configs.get("llama3.2-1b").scaled(compute_dtype="float32", **kw)


def _train_flops(model, cfg, B: int, S: int) -> int:
    """Products of one rematerialised step: every weight's matmul forward,
    twice in the backward and once more in the recompute (the tied head
    is not recomputed), and the causal attention's live pairs: forward,
    recompute and a backward of twice the forward."""
    head = cfg.vocab * cfg.d_model
    layers = model.n_params - head
    tokens = B * S
    live = B * cfg.n_heads * S * (S + 1) // 2
    attn = cfg.n_layers * 4 * (4 * cfg.head_dim * live)
    return 2 * tokens * (3 * (layers + head) + layers) + attn


def _sync() -> None:
    if TRAIN_DEVICE == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def _train_ranges():
    """Name the plain attention backward and the optimizer update in the
    profiler (record_function ranges around the port's own functions)."""
    from torch.profiler import record_function
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.train import loop

    def ranged(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    saved = ops.attention_bwd_ref, loop.adamw_update
    ops.attention_bwd_ref = ranged("attention_backward", saved[0])
    loop.adamw_update = ranged("adamw_update", saved[1])
    try:
        yield
    finally:
        ops.attention_bwd_ref, loop.adamw_update = saved


def _train_profile(step, opt, batch) -> dict:
    """Device time of one step by kernel and by the port's ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    _sync()
    with _train_ranges(), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(opt, {"tokens": batch})
        _sync()
        wall = time.perf_counter() - t0
    dev, table = _kernel_table(prof, top=12, ranges=TRAIN_RANGES)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and e.key not in TRAIN_RANGES]
    gemm = sum(e.self_device_time_total for e in kernels
               if "gemm" in e.key.lower())
    flash = sum(e.self_device_time_total for e in kernels
                if "flash_fwd" in e.key)
    ranges = {}     # the host range's or the card's annotation, the larger
    for e in prof.key_averages():
        if e.key in TRAIN_RANGES:
            ranges[e.key] = max(ranges.get(e.key, 0), e.device_time_total)
    return dict(wall_ms=wall * 1e3, device_ms=dev / 1e3,
                busy_share=dev / 1e3 / (wall * 1e3) if wall else None,
                gemm_ms=gemm / 1e3, flash_fwd_ms=flash / 1e3,
                attention_backward_ms=ranges.get("attention_backward", 0) / 1e3,
                adamw_update_ms=ranges.get("adamw_update", 0) / 1e3,
                top=table)


def _grads(model, batch) -> tuple[float, dict]:
    model.requires_grad_(True)
    loss = model.loss({"tokens": batch})
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def _plain_autograd(q, k, v, *, causal=True, window=0, kv_len=None,
                    body="auto"):
    """attention_ref under autograd on the model's layout."""
    from repro_torch.kernels.flash_attention import attention_ref
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        kv_len=kv_len)
    return out.transpose(1, 2)


def phase_train(seed: int, tmp: str) -> dict:
    """``make_train_step`` on full-width, full-depth llama3.2-1b at f32 from
    a Bullion corpus through ``BullionLoader``: TRAIN["steps"] steps, their
    times, launches (2 x 16 a step, all simt) and memory; one step traced
    by kernel; at full width and one layer, the kernel route's loss and
    gradients against attention_ref under autograd, and the loss of one
    repeated batch falling; the gradient norm against depth; steps at bf16
    compute (all wgmma); the launcher at --smoke with a checkpoint and a
    resume; and a restored step equal to the uninterrupted one."""
    from repro_torch.data import BullionLoader, write_lm_corpus
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.zoo import build
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    dev = TRAIN_DEVICE
    B, S = TRAIN["batch"], TRAIN["seq"]
    cfg = _train_cfg()
    corpus = os.path.join(tmp, "train_corpus.bln")
    write_lm_corpus(corpus, vocab=cfg.vocab, seed=seed, **TRAIN_CORPUS)
    t0 = time.perf_counter()
    model = build(cfg, device=dev, seed=seed)
    opt = adamw_init(model)
    step = make_train_step(model, AdamWConfig(**TRAIN_OPT), device=dev)
    _sync()
    init_s = time.perf_counter() - t0
    loader = BullionLoader(corpus, batch_size=B, seq_len=S, device=dev)
    it = iter(loader)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, step_ms, wait_ms, norms, first = [], [], [], [], None
    for i in range(TRAIN["steps"]):                      # the main path
        t0 = time.perf_counter()
        batch, _ = next(it)
        t1 = time.perf_counter()
        first = batch if first is None else first
        metrics = step(opt, {"tokens": batch})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        _sync()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        wait_ms.append((t1 - t0) * 1e3)
        emit("train", step=i + 1, loss=losses[-1], step_ms=step_ms[-1],
             loader_wait_ms=wait_ms[-1],
             grad_norm=norms[-1], lr=float(metrics["lr"]))
    launched = counts()
    by_body = dict(flash_attention.launches_by_body)
    peak = torch.cuda.max_memory_allocated()
    want = 2 * cfg.n_layers * TRAIN["steps"]
    check(launched == dict(flash_attention=want, range_mask=0, dequant=0,
                           dequant_packed=0, bitunpack=0, page_unpack=0),
          f"training launched {launched}, expected flash_attention {want} "
          "times (2 a layer a step) and no other kernel")
    check(by_body == dict(simt=want, mma=0, wgmma=0),
          f"f32 training launched the bodies {by_body}, expected simt only")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    prof = _train_profile(step, opt, next(it)[0])
    # Not a check: at full depth the random init's gradient norm is near
    # 1e11 (grad_norm_by_depth below), and no step size the schedule takes
    # moves the loss by more than its noise; the falling loss is held at
    # one layer, below.
    repeated = [float(step(opt, {"tokens": first})["loss"])
                for _ in range(TRAIN["repeat_steps"])]
    check(all(math.isfinite(x) for x in repeated), f"losses {repeated}")
    loader.close()
    median = float(np.median(step_ms[1:]))
    flops = _train_flops(model, cfg, B, S)
    bound_ms = flops / F32_FLOP_PER_S * 1e3
    row = dict(arch=cfg.name, n_params=model.n_params,
               n_layers=cfg.n_layers, batch=B, seq=S, dtype="float32",
               tf32=torch.backends.cuda.matmul.allow_tf32, init_s=init_s,
               steps=len(losses), losses=losses, grad_norms=norms,
               repeated_batch_losses=repeated,
               step_ms=step_ms, loader_wait_ms=wait_ms,
               train_step_ms=median, train_tokens_per_s=B * S / median * 1e3,
               step_flops=flops, bound_ms=bound_ms,
               bound_tokens_per_s=B * S / bound_ms * 1e3,
               bound_share=bound_ms / median,
               max_memory_allocated_gb=peak / 1e9,
               flash_launches=launched["flash_attention"],
               flash_launches_by_body=by_body)
    emit("train", **row)
    emit("train", profile="one_step", **prof)
    del model, opt, step
    if dev == "cuda":
        torch.cuda.empty_cache()

    # route against route at full width, one layer
    one = _train_cfg(segments=((("full:swiglu",), 1),))
    m1 = build(one, device=dev, seed=seed)
    loss_k, g_k = _grads(m1, first)
    with model_attention(_plain_autograd):
        loss_p, g_p = _grads(m1, first)
    tol = TOL[torch.float32]
    errs = {k: (g_k[k] - g_p[k]).abs().max().item() for k in g_k}
    scale = {k: g_p[k].abs().max().item() for k in g_p}
    emit("train", check="kernel_vs_plain_one_layer", n_layers=1,
         loss_kernel=loss_k, loss_plain=loss_p, loss_err=abs(loss_k - loss_p),
         max_grad_err=max(errs.values()), grad_errs=errs, grad_max=scale,
         tol=tol)
    check(abs(loss_k - loss_p) < tol, f"one-layer loss {loss_k} vs {loss_p}")
    bad = {k: e for k, e in errs.items() if not e < tol * max(1.0, scale[k])}
    check(not bad, f"one-layer gradients beyond {tol}: {bad}")
    del g_k, g_p
    # the loss of one repeated batch falls (one layer, full width)
    step1 = make_train_step(m1, AdamWConfig(**TRAIN_OPT), device=dev)
    opt1 = adamw_init(m1)
    falls = [float(step1(opt1, {"tokens": first})["loss"])
             for _ in range(TRAIN["repeat_steps"])]
    emit("train", check="repeated_batch_loss_falls", n_layers=1,
         losses=falls, full_depth_losses=repeated)
    check(all(math.isfinite(x) for x in falls) and falls[-1] < falls[0],
          f"one layer: the loss of one repeated batch did not fall: {falls}")
    del m1, opt1, step1
    # the gradient norm of the random init against depth, at full width
    depth_norms = {}
    for layers in TRAIN["norm_depths"]:
        m = build(_train_cfg(segments=((("full:swiglu",), layers),)),
                  device=dev, seed=seed)
        _, g = _grads(m, first)
        depth_norms[layers] = math.sqrt(sum(float(x.double().square().sum())
                                            for x in g.values()))
        del m, g
    depth_norms[cfg.n_layers] = norms[0]
    emit("train", diagnostic="grad_norm_by_depth", batch="the first",
         grad_norm=depth_norms)

    # bf16 compute (f32 master weights): the wgmma body
    bcfg = _train_cfg().scaled(compute_dtype="bfloat16")
    model = build(bcfg, device=dev, seed=seed)
    opt = adamw_init(model)
    step = make_train_step(model, AdamWConfig(**TRAIN_OPT), device=dev)
    loader = BullionLoader(corpus, batch_size=B, seq_len=S, device=dev)
    it = iter(loader)
    zero_counts()
    bf16 = []
    for _ in range(TRAIN["bf16_steps"]):
        t0 = time.perf_counter()
        bf16.append(float(step(opt, {"tokens": next(it)[0]})["loss"]))
        _sync()
        emit("train", dtype="bfloat16", loss=bf16[-1],
             step_ms=(time.perf_counter() - t0) * 1e3)
    loader.close()
    bwant = 2 * bcfg.n_layers * TRAIN["bf16_steps"]
    by_body_bf16 = dict(flash_attention.launches_by_body)
    check(by_body_bf16 == dict(simt=0, mma=0, wgmma=bwant),
          f"bf16 training launched the bodies {by_body_bf16}, expected "
          f"wgmma {bwant} times")
    check(all(math.isfinite(x) for x in bf16), f"bf16 losses {bf16}")
    del model, opt, step
    if dev == "cuda":
        torch.cuda.empty_cache()
    os.unlink(corpus)
    emit("train", dtype="bfloat16", losses=bf16, launches_by_body=by_body_bf16)

    launcher = _train_launcher(seed, tmp)
    return dict(row, launches=launched["flash_attention"],
                bf16_launches=bwant, launcher=launcher)


# ---------------------------------------------------------------------------
# phase distributed: the sharded training step on a (1, 1) NCCL mesh
# ---------------------------------------------------------------------------

DIST = dict(steps=3, step_tol=2e-4, moe_tol=2e-3, rwkv_rel_tol=1e-5,
            moe_layers=2, rwkv_layers=1)


def _dist_group(tmp: str, name: str = "dist_store"):
    """The process group (NCCL on the card, through a FileStore ``name`` in
    ``tmp``) and the port's (1, 1) ("data", "model") mesh over it."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_test_mesh
    torch.cuda.set_device(0)
    store = tdist.FileStore(os.path.join(tmp, name), 1)
    tdist.init_process_group("nccl", store=store, rank=0, world_size=1)
    return make_test_mesh(1, 1)


def _whole(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def _param_gap(model, want: dict) -> tuple[float, str]:
    """The largest |parameter - want| over the model, and where."""
    gap, where = 0.0, ""
    for name, p in model.named_parameters():
        g = (_whole(p) - want[name]).abs().max().item()
        if g >= gap:
            gap, where = g, name
    return gap, where


def _dist_step_pair(cfg, seed, batch, mesh, steps: int,
                    profile: bool = False):
    """One step of the unsharded model, then ``steps`` of the sharded one
    from the same parameters and batch; the unsharded model is freed before
    the sharded one is built. Returns (the sharded model, its losses, the
    unsharded loss, the largest parameter gap after one step and where,
    the step times (ms), the launches of the sharded steps, flash's by
    body, the peak memory). ``profile``: then one more step traced by
    kernel, its line emitted."""
    from repro_torch.distributed import make_dist
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.zoo import build
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    m0 = build(cfg, device="cuda", seed=seed)
    s0 = make_train_step(m0, AdamWConfig(**TRAIN_OPT), device="cuda")
    loss0 = float(s0(adamw_init(m0), {"tokens": batch})["loss"])
    want = {k: p.detach().clone() for k, p in m0.named_parameters()}
    del m0, s0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, device="cuda", seed=seed, dist=make_dist(mesh))
    opt = adamw_init(model)
    step = make_train_step(model, AdamWConfig(**TRAIN_OPT), device="cuda")
    torch.cuda.synchronize()
    zero_counts()
    losses, ms, gap = [], [], None
    for i in range(steps):                               # the main path
        t0 = time.perf_counter()
        losses.append(float(step(opt, {"tokens": batch})["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            gap = _param_gap(model, want)
            del want
    launched = counts()
    by_body = dict(flash_attention.launches_by_body)
    peak = torch.cuda.max_memory_allocated()
    if profile:
        emit("distributed", profile="one_step",
             **_train_profile(step, opt, batch))
    return model, losses, loss0, gap, ms, launched, by_body, peak


def _dist_moe(seed: int, mesh, B: int, S: int) -> dict:
    """deepseek-moe-16b at full width, a dense and a MoE layer, f32, with
    capacity for every pair: the loss through the sharded path (the rank's
    chunk slice, psum over 'model') against the local path."""
    import repro_torch.configs as configs
    from repro_torch.distributed import make_dist
    from repro_torch.models.moe import sharded_route
    from repro_torch.models.zoo import build
    base = configs.get("deepseek_moe_16b")
    cfg = base.scaled(compute_dtype="float32",
                      capacity_factor=base.n_experts / base.top_k,
                      segments=((("full:swiglu",), 1),
                                (("full:moe",), DIST["moe_layers"] - 1)))
    toks = torch.randint(0, cfg.vocab, (B, S + 1),
                         generator=torch.Generator().manual_seed(seed))
    local = build(cfg, device="cuda", seed=seed)
    with torch.no_grad():
        want = float(local.loss({"tokens": toks}))
    del local
    model = build(cfg, device="cuda", seed=seed, dist=make_dist(mesh))
    route = sharded_route(model.segments[1].b0[0].moe, model.dist)
    zero_counts()
    with torch.no_grad():
        got = float(model.loss({"tokens": toks}))
    launched = counts()["flash_attention"]
    del model
    row = dict(arch=cfg.name, n_layers=cfg.n_layers, batch=B, seq=S,
               capacity_factor=cfg.capacity_factor, sharded_route=route,
               loss_sharded=got, loss_local=want, gap=abs(got - want),
               tol=DIST["moe_tol"], flash_launches=launched)
    emit("distributed", check="moe_sharded_vs_local", **row)
    check(route, "deepseek-moe-16b on the (1, 1) mesh took the local path")
    check(abs(got - want) < DIST["moe_tol"],
          f"sharded MoE loss {got} vs local {want}")
    check(launched == cfg.n_layers,
          f"the MoE model's loss launched flash {launched} times, expected "
          f"{cfg.n_layers} (one a layer, on local shards)")
    return row


def _dist_rwkv(seed: int, mesh, B: int, S: int) -> dict:
    """rwkv6-7b at full width and one layer, f32: the loss under the mesh
    (the WKV recurrence on local heads) against the unsharded loss."""
    import repro_torch.configs as configs
    from repro_torch.distributed import make_dist
    from repro_torch.models.zoo import build
    cfg = configs.get("rwkv6_7b").scaled(
        compute_dtype="float32",
        segments=((("rwkv:none",), DIST["rwkv_layers"]),))
    toks = torch.randint(0, cfg.vocab, (B, S + 1),
                         generator=torch.Generator().manual_seed(seed))
    losses = []
    for dist in (None, make_dist(mesh)):
        m = build(cfg, device="cuda", seed=seed, dist=dist)
        with torch.no_grad():
            losses.append(float(m.loss({"tokens": toks})))
        del m
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    row = dict(arch=cfg.name, n_layers=cfg.n_layers, batch=B, seq=S,
               loss_sharded=losses[1], loss_unsharded=losses[0], rel_gap=rel,
               tol=DIST["rwkv_rel_tol"])
    emit("distributed", check="rwkv_sharded_vs_unsharded", **row)
    check(rel < DIST["rwkv_rel_tol"], f"sharded RWKV loss {losses}")
    return row


def _dist_elastic(seed, cfg, model, batch, mesh, tmp) -> dict:
    """Save the sharded parameters with ``CheckpointManager``, restore them
    with ``elastic_restore`` onto the mesh into a model of another seed:
    bit-equal, placed as ``spec_tree`` asks; then one step of each from a
    fresh optimizer state: finite, the same loss, and parameters within
    the step bound (the embedding's gradient sums in any order)."""
    from repro_torch.distributed import make_dist
    from repro_torch.distributed.placement import placements
    from repro_torch.models.base import by_name, spec_tree
    from repro_torch.models.zoo import build
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.elastic import elastic_restore
    t0 = time.perf_counter()
    mgr = CheckpointManager(os.path.join(tmp, "dist_ckpt"), keep=1)
    mgr.save(DIST["steps"] + 1, model)     # the timed steps and the traced one
    mgr.wait()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh = build(cfg, device="cuda", seed=seed + 1,
                  dist=make_dist(mesh))
    _, manifest = elastic_restore(mgr, fresh, fresh.decl, mesh)
    restore_s = time.perf_counter() - t0
    specs = spec_tree(fresh.decl, fresh.dist.rules, mesh)
    old = dict(model.named_parameters())
    equal, placed = True, True
    for name, p in fresh.named_parameters():
        placed &= tuple(p.placements) == placements(by_name(specs, name),
                                                    mesh)
        equal &= bool(torch.equal(p.to_local(), old[name].to_local()))
    del old
    after = []
    for m in (model, fresh):
        s = make_train_step(m, AdamWConfig(**TRAIN_OPT), device="cuda")
        after.append(float(s(adamw_init(m), {"tokens": batch})["loss"]))
        del s
    gap, where = _param_gap(fresh, {k: _whole(p) for k, p in
                                    model.named_parameters()})
    row = dict(step=manifest["step"], bit_equal=equal, placed=placed,
               save_s=save_s, restore_s=restore_s,
               next_loss_uninterrupted=after[0], next_loss_restored=after[1],
               next_step_param_gap=gap)
    emit("distributed", check="elastic_restore", **row)
    check(equal and placed, f"elastic restore: bit-equal {equal}, "
          f"placed {placed}")
    check(all(math.isfinite(x) for x in after) and after[0] == after[1]
          and gap < DIST["step_tol"], f"restored step {after}, parameter "
          f"gap {gap} at {where}")
    return row


def phase_distributed(seed: int, tmp: str) -> dict:
    """The sharded training step through ``build(cfg, dist=make_dist(mesh))``
    and ``make_train_step`` on a (1, 1) ("data", "model") mesh over NCCL:
    full-width, full-depth llama3.2-1b at f32 on phase train's first batch,
    DIST["steps"] steps (32 flash launches a step, all simt, on each rank's
    local shards under local_map), the loss and every parameter after one
    step against the unsharded step (at one layer where the random init's
    depth amplifies rounding past the bound, the full-depth gap printed as
    a witness); deepseek-moe-16b's sharded MoE path against the local one;
    rwkv6-7b's sharded loss; an elastic restore of the sharded parameters.
    Returns the phase's row, with the sharded steps' flash launches."""
    import torch.distributed as tdist
    from repro_torch.data import BullionLoader, write_lm_corpus
    B, S = TRAIN["batch"], TRAIN["seq"]
    cfg = _train_cfg()
    corpus = os.path.join(tmp, "dist_corpus.bln")
    write_lm_corpus(corpus, vocab=cfg.vocab, seed=seed, **TRAIN_CORPUS)
    loader = BullionLoader(corpus, batch_size=B, seq_len=S, device="cuda")
    batch = next(iter(loader))[0]
    loader.close()
    os.unlink(corpus)
    mesh = _dist_group(tmp)
    try:
        (model, losses, loss0, (gap, where), ms, launched, by_body,
         peak) = _dist_step_pair(cfg, seed, batch, mesh, DIST["steps"],
                                 profile=True)
        torch.cuda.empty_cache()
        want = 2 * cfg.n_layers * DIST["steps"]
        row = dict(arch=cfg.name, n_layers=cfg.n_layers, batch=B, seq=S,
                   dtype="float32", mesh=dict(zip(mesh.mesh_dim_names,
                                                  mesh.shape)),
                   backend=tdist.get_backend(), losses=losses,
                   step_ms=ms, dist_step_ms=float(np.median(ms[1:])),
                   max_memory_allocated_gb=peak / 1e9,
                   flash_launches=launched["flash_attention"],
                   flash_launches_per_step=launched["flash_attention"]
                   / DIST["steps"], flash_launches_by_body=by_body,
                   loss_gap=abs(losses[0] - loss0), loss_unsharded=loss0,
                   param_gap=gap, param_gap_at=where, tol=DIST["step_tol"])
        emit("distributed", **row)
        check(launched == dict(flash_attention=want, range_mask=0, dequant=0,
                               dequant_packed=0, bitunpack=0, page_unpack=0),
              f"the sharded steps launched {launched}, expected "
              f"flash_attention {want} times (2 a layer a step)")
        check(by_body == dict(simt=want, mma=0, wgmma=0),
              f"the sharded f32 steps launched the bodies {by_body}")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        check(abs(losses[0] - loss0) < DIST["step_tol"],
              f"sharded loss {losses[0]} vs unsharded {loss0}")
        if gap >= DIST["step_tol"]:
            # the depth witness: hold one layer at full width
            emit("distributed", depth_witness=True, n_layers=cfg.n_layers,
                 param_gap=gap, param_gap_at=where)
            one = cfg.scaled(segments=((("full:swiglu",), 1),))
            m1, l1, l0, (g1, w1), *_ = _dist_step_pair(one, seed, batch,
                                                        mesh, 1)
            del m1
            emit("distributed", check="one_layer", loss_gap=abs(l1[0] - l0),
                 param_gap=g1, param_gap_at=w1, tol=DIST["step_tol"])
            check(abs(l1[0] - l0) < DIST["step_tol"]
                  and g1 < DIST["step_tol"],
                  f"one layer: loss {l1[0]} vs {l0}, parameters {g1} at {w1}")
        row["elastic"] = _dist_elastic(seed, cfg, model, batch, mesh, tmp)
        del model
        torch.cuda.empty_cache()
        row["moe"] = _dist_moe(seed, mesh, B, S)
        row["rwkv"] = _dist_rwkv(seed, mesh, B, S)
    finally:
        tdist.destroy_process_group()
    return row


SHARDED_STEPS = 8      # decode steps of each family's sharded check
# one pattern of each family, at phase families' route-check depths:
# (arch, segments, dtype, batch, prompt)
SHARDED_FAMILIES = (
    ("deepseek_moe_16b", ((("full:swiglu",), 1), (("full:moe",), 1)),
     torch.bfloat16, 2, 512),
    ("minicpm3_4b", ((("mla:swiglu",), 1),), torch.bfloat16, 2, 512),
    ("recurrentgemma_9b", None, torch.float32, 2, 2100),
    ("rwkv6_7b", ((("rwkv:none",), 1),), torch.bfloat16, 2, 512),
    ("whisper_base", None, torch.float32, 2, 64),
)


def _sharded_cfg(arch, segments, dtype):
    import repro_torch.configs as configs
    cfg = configs.get(arch)
    if arch == "recurrentgemma_9b":
        segments = ((cfg.segments[0][0], 1),)
    if arch == "whisper_base":
        segments = ((cfg.segments[0][0], 1),)
        cfg = cfg.scaled(encoder=dataclasses.replace(cfg.encoder, n_layers=1))
    if cfg.n_experts:
        cfg = cfg.scaled(capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg.scaled(segments=segments,
                      compute_dtype=str(dtype).replace("torch.", ""))


def _cache_gaps(c0, c1, path="") -> dict:
    """|sharded - unsharded| at most, each cache tensor (whole), by path."""
    if isinstance(c0, dict):
        return {k: v for n in c0 for k, v in
                _cache_gaps(c0[n], c1[n], f"{path}/{n}").items()}
    if isinstance(c0, list):
        return {k: v for i in range(len(c0)) for k, v in
                _cache_gaps(c0[i], c1[i], f"{path}/{i}").items()}
    if isinstance(c0, torch.Tensor):
        return {path: _bound(c0, _whole(c1))}
    check(c0 == c1, f"cache {path}: {c0} vs {c1}")
    return {}


def _sharded_pair(cfg, seed, mesh, B, P, steps, dtype) -> dict:
    """The unsharded model and the same parameters on ``mesh``: a prefill
    of P tokens and ``steps`` decode steps (the unsharded model's greedy
    tokens fed to both), each call's logits and then every cache tensor
    held to the unsharded run within phase serve's bound (2e-2 x max|ref|
    + 1e-3)."""
    from repro_torch.distributed import make_dist
    from repro_torch.models.zoo import build
    m0 = build(cfg, device="cuda", dtype=dtype, seed=seed)
    m1 = build(cfg, device="cuda", dtype=dtype, seed=seed,
               dist=make_dist(mesh))
    rng = np.random.default_rng(seed + 7)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)),
                                       device="cuda")}
    frames = _frames(cfg, B, rng)
    if frames is not None:
        batch["frames"] = torch.as_tensor(frames, device="cuda")
    gaps = []
    with torch.no_grad():
        c0 = m0.init_cache(B, P + steps, dtype=torch.float32)
        c1 = m1.init_cache(B, P + steps, dtype=torch.float32)
        l0, c0 = m0.prefill(batch, c0)
        l1, c1 = m1.prefill(batch, c1)
        gaps.append(_bound(l0, _whole(l1)))
        for _ in range(steps):
            tok = l0.argmax(-1)[:, None]
            l0, c0 = m0.decode_step(c0, tok)
            l1, c1 = m1.decode_step(c1, tok)
            gaps.append(_bound(l0, _whole(l1)))
        check(bool(torch.isfinite(l0).all()), f"{cfg.name}: logits")
        check(int(c0.pop("pos")) == int(c1.pop("pos")) == P + steps,
              f"{cfg.name}: the positions")
        cache = _cache_gaps(c0, c1)
    del m0, m1, c0, c1
    torch.cuda.empty_cache()
    row = dict(arch=cfg.name, n_layers=cfg.n_layers,
               dtype=str(dtype).replace("torch.", ""), batch=B, prompt_len=P,
               steps=steps, logit_gap=[g for g, _ in gaps],
               logit_bound=[b for _, b in gaps],
               cache_gap={k: g for k, (g, _) in cache.items()})
    emit("sharded_serve", **row)
    check(all(g < b for g, b in gaps), f"{cfg.name} sharded logits {gaps}")
    check(all(g < b for g, b in cache.values()),
          f"{cfg.name} sharded caches {cache}")
    return row


def _fake_serve_count(cfg, B: int, P: int, max_seq: int, dtype) -> dict:
    """``dryrun.serve_count`` in a subprocess (a fake group cannot share
    this process with NCCL's): the same prefill's count on fake tensors
    over a fake group of one."""
    code = ("import json, torch\n"
            "from repro_torch.launch import dryrun\n"
            "import repro_torch.configs as c\n"
            f"cfg = c.get({cfg.name!r}).scaled(compute_dtype="
            f"{cfg.compute_dtype!r})\n"
            f"r = dryrun.serve_count(cfg, (1, 1), {B}, {P}, {max_seq}, "
            f"torch.{str(dtype).replace('torch.', '')})\n"
            "print(json.dumps(r))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    check(r.returncode == 0, f"serve_count: {r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def phase_sharded_serve(seed: int, tmp: str, prompts, gen, serve: dict):
    """ServeEngine with a sharded model on the (1, 1) NCCL mesh: llama3.2-1b
    at full width and depth, bf16, phase serve's prompts and work; its
    launches, tokens, times and cost count; then each family's pattern
    sharded against unsharded. Returns the prefill's flash launches and
    the decode-attention kernel's calls of the main path (on local shards,
    ``local_heads``)."""
    import torch.distributed as tdist
    import repro_torch.configs as configs
    from repro_torch.distributed import make_dist
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import hlo_cost, roofline
    from repro_torch.models.zoo import build
    from repro_torch.serve import ServeEngine
    cfg = configs.get("llama3.2-1b").scaled(compute_dtype="bfloat16")
    mesh = _dist_group(tmp, "sharded_serve_store")
    try:
        model = build(cfg, device="cuda", dtype=torch.bfloat16, seed=seed,
                      dist=make_dist(mesh))
        eng = ServeEngine(model, max_seq=SERVE_MAX_SEQ, device="cuda")
        eng.generate(prompts, max_new_tokens=SERVE_NEW)          # warm-up
        torch.cuda.synchronize()
        zero_counts()
        calls0 = decode_kernel_calls()
        out = eng.generate(prompts, max_new_tokens=SERVE_NEW)   # the main path
        launched = counts()
        decode_calls = decode_kernel_calls() - calls0
        by_body = dict(flash_attention.launches_by_body)
        launches = launched["flash_attention"]
        # the real sharded prefill counted (the kernel launched), and the
        # same shapes on fake tensors
        toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
        cache = model.init_cache(SERVE_B, SERVE_MAX_SEQ, dtype=torch.float32)
        before = flash_attention.launches
        with torch.no_grad():
            real = hlo_cost.analyze(model.prefill, {"tokens": toks}, cache)
        counted_launches = flash_attention.launches - before
        del cache, real["out"]
        t0 = time.perf_counter()
        fake = _fake_serve_count(cfg, SERVE_B, SERVE_P, SERVE_MAX_SEQ,
                                 torch.bfloat16)
        fake_count_s = time.perf_counter() - t0
        terms = roofline.roofline_terms(real["flops"], real["bytes"],
                                        real["collective_bytes"])
        prefill_ms = out["prefill_s"] * 1e3
        row = dict(arch=cfg.name, n_layers=cfg.n_layers, batch=SERVE_B,
                   prompt_len=SERVE_P, new_tokens=SERVE_NEW,
                   mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                   backend=tdist.get_backend(), prefill_ms=prefill_ms,
                   decode_ms_per_step=out["decode_s"] * 1e3 / SERVE_NEW,
                   serve_prefill_ms=serve["prefill_ms"],
                   serve_decode_ms_per_step=serve["decode_ms_per_step"],
                   flash_launches_per_prefill=launches,
                   flash_launches_by_body=by_body,
                   tokens_equal_serve=bool((out["tokens"] == gen).all()),
                   counted_flops=real["flops"], fake_flops=fake["flops"],
                   counted_bytes=real["bytes"],
                   counted_collective_bytes=real["collective_bytes"],
                   counted_flash_launches=counted_launches,
                   decode_kernel_calls=decode_calls,
                   roofline_bound_ms=terms["bound_s"] * 1e3,
                   roofline_dominant=terms["dominant"],
                   serve_bounds_prefill_ms=serve["prefill_bound_ms"],
                   fake_count_s=fake_count_s)
        emit("sharded_serve", **row)
        check(launched == dict(flash_attention=cfg.n_layers, range_mask=0,
                               dequant=0, dequant_packed=0, bitunpack=0,
                           page_unpack=0),
              f"sharded serving launched {launched}")
        check(by_body == dict(simt=0, mma=0, wgmma=cfg.n_layers),
              f"sharded serving launched the bodies {by_body}")
        check(decode_calls == cache_attending(cfg) * SERVE_NEW,
              f"sharded serving called the decode-attention kernel "
              f"{decode_calls} times, expected {cache_attending(cfg)} "
              f"layers x {SERVE_NEW} steps")
        check(row["tokens_equal_serve"],
              "sharded tokens differ from phase serve's")
        check(counted_launches == cfg.n_layers,
              f"the counted prefill launched {counted_launches}")
        check(real["flops"] == fake["flops"],
              f"counted FLOPs {real['flops']} vs fake {fake['flops']}")
        check(terms["bound_s"] > 0, "roofline bound")
        del model, eng
        torch.cuda.empty_cache()
        _sharded_pair(cfg, seed, mesh, SERVE_B, SERVE_P, 4, torch.bfloat16)
        for arch, segments, dtype, B, P in SHARDED_FAMILIES:
            _sharded_pair(_sharded_cfg(arch, segments, dtype), seed, mesh,
                          B, P, SHARDED_STEPS, dtype)
    finally:
        tdist.destroy_process_group()
    return launches, decode_calls


DRYRUN_CELLS = (("llama3.2-1b", None, False), ("llama3.2-1b", "decode_32k", True),
                ("deepseek-moe-16b", "prefill_32k", False),
                ("whisper-base", "prefill_32k", False))


def phase_dryrun(tmp: str) -> dict:
    """``python -m repro_torch.launch.dryrun`` for each of DRYRUN_CELLS (an
    arch on every shape where the shape is None), artifacts under
    ``tmp``; every record ok (long_500k of a full-attention family
    skipped), its n_devices the mesh's, its bound positive; then
    ``launch.report``'s table of each mesh."""
    out = os.path.join(tmp, "dryrun")
    t0 = time.perf_counter()
    for arch, shape, multi_pod in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--out", out]
        if shape:
            cmd += ["--shape", shape]
        if multi_pod:
            cmd += ["--multi-pod"]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                           cwd=ROOT, env=dict(os.environ,
                                              PYTHONPATH=str(ROOT / "src")))
        check(r.returncode == 0, f"dryrun {arch} {shape}: "
              f"{r.stdout[-2000:]} {r.stderr[-2000:]}")
    recs = []
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name)) as f:
            rec = json.load(f)
        recs.append(rec)
        keep = {k: rec.get(k) for k in ("arch", "shape", "mesh", "status",
                                        "n_devices", "trace_s", "memory",
                                        "flops_per_device",
                                        "bytes_per_device", "roofline")}
        keep["collective_bytes"] = rec.get("collectives", {}).get(
            "total_bytes")
        emit("dryrun", **keep)
        if rec["status"] == "skipped":
            check(rec["shape"] == "long_500k", f"skipped {rec}")
            continue
        check(rec["status"] == "ok", f"dryrun {name}: {rec.get('error')}")
        check(rec["n_devices"] == (512 if rec["mesh"] == "2x16x16" else 256),
              f"{name}: n_devices {rec['n_devices']}")
        check(rec["roofline"]["bound_s"] > 0, f"{name}: bound")
    check(len([r for r in recs if r["status"] == "ok"]) == 6,
          f"dryrun records {[(r['arch'], r['shape'], r['mesh']) for r in recs]}")
    r = subprocess.run([sys.executable, "-c",
                        "import sys; from repro_torch.launch import report; "
                        f"report.ARTIFACT_DIR = {out!r}; "
                        "print(report.table('16x16')); "
                        "print(report.table('2x16x16'))"],
                       capture_output=True, text=True, timeout=120, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    check(r.returncode == 0, f"report: {r.stderr[-2000:]}")
    emit("dryrun", seconds=time.perf_counter() - t0, report=r.stdout)
    return {"seconds": time.perf_counter() - t0}


def _train_launcher(seed: int, tmp: str) -> dict:
    """``python -m repro_torch.launch.train --smoke`` (``main``) to step 6
    with checkpoints every 3, then again to step 8: it resumes at 6. And a
    checkpoint of 3 steps restored into a fresh model and optimizer takes a
    step equal, bit for bit, to the uninterrupted model's."""
    import repro_torch.configs as configs
    from repro_torch.launch.train import main
    from repro_torch.models.zoo import build
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.checkpoint import CheckpointManager

    dev = TRAIN_DEVICE
    args = TRAIN_LAUNCHER + ["--data", os.path.join(tmp, "launch_data"),
                             "--ckpt", os.path.join(tmp, "launch_ckpt"),
                             "--device", dev]
    out = StringIO()
    with contextlib.redirect_stdout(out):
        first = main(args + ["--steps", "6"])
        resumed = main(args + ["--steps", "8"])
    kept = sorted(os.listdir(os.path.join(tmp, "launch_ckpt")))
    check(len(first) == 6 and len(resumed) == 2 and
          all(math.isfinite(x) for x in first + resumed),
          f"launcher losses {first} then {resumed}")
    check("resumed from step 6" in out.getvalue(),
          "the second launcher run did not resume from step 6")
    check(kept == ["step_000000006", "step_000000008"],
          f"launcher checkpoints {kept}")

    cfg = configs.get_smoke("llama3.2-1b").scaled(compute_dtype="float32")
    rng = np.random.default_rng(seed)
    batches = [rng.integers(0, cfg.vocab, (2, 33)).astype(np.int32)
               for _ in range(4)]
    model = build(cfg, device=dev, seed=seed)
    opt = adamw_init(model)
    step = make_train_step(model, AdamWConfig(**TRAIN_OPT), device=dev)
    for b in batches[:3]:
        step(opt, {"tokens": b})
    mgr = CheckpointManager(os.path.join(tmp, "resume_ckpt"), keep=1)
    mgr.save(3, (model, opt))
    mgr.wait()
    model2 = build(cfg, device=dev, seed=seed + 1)
    opt2 = adamw_init(model2)
    mgr.restore((model2, opt2), device=dev)
    step2 = make_train_step(model2, AdamWConfig(**TRAIN_OPT), device=dev)
    a = float(step(opt, {"tokens": batches[3]})["loss"])
    b = float(step2(opt2, {"tokens": batches[3]})["loss"])
    same = a == b and all(torch.equal(x, y) for x, y in zip(
        model.parameters(), model2.parameters())) and all(
        torch.equal(opt[k][n], opt2[k][n]) for k in ("m", "v")
        for n in opt[k]) and int(opt["step"]) == int(opt2["step"])
    check(same, f"the resumed step differs from the uninterrupted one: "
          f"loss {b} vs {a}")
    res = dict(first_losses=first, resumed_losses=resumed, checkpoints=kept,
               resume_step_equal=same, resume_loss=b)
    emit("train", case="launcher_smoke", **res)
    return res


def phase_train_times(seed: int) -> tuple[dict, float]:
    """The flash kernel at the training shape (f32, simt) against its
    bound, its plain version and SDPA at f32, warm and cold; and the plain
    backward's device time at that shape beside it."""
    from repro_torch.kernels.flash_attention import (attention,
                                                     attention_bwd_ref,
                                                     attention_ref)
    c = TRAIN_CASE
    B, H, Hkv, S, D = c["B"], c["H"], c["Hkv"], c["S"], c["D"]
    q, k, v = _inputs(np.random.default_rng(seed), B, H, Hkv, S, D,
                      c["dtype"], "bshd")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bytes_moved, flops, live_pairs = _flash_work(B, H, Hkv, S, D,
                                                 q.element_size())
    row, extra = _time_kernel(
        lambda: attention(q, k, v, causal=True, body="simt"),
        lambda: attention_ref(qt, kt, vt, causal=True),
        bytes_moved=bytes_moved, ops=flops, op_rate=F32_FLOP_PER_S,
        library=lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    out = attention(q, k, v, causal=True).transpose(1, 2)
    dout = torch.randn_like(out)
    backward_ms = _device_ms_per_call(
        lambda: attention_bwd_ref(qt, kt, vt, out, dout, causal=True),
        calls=10)
    emit("train_times", shape=[B, H, Hkv, S, D], dtype="float32",
         causal=True, body="simt", **extra, live_scores=live_pairs,
         plain_backward_ms=backward_ms,
         simt_over_library=row["ms"] / row["library_ms"], **row)
    return dict(row, cold_l2_ms=extra["cold_l2_ms"],
                library_cold_l2_ms=extra["library_cold_l2_ms"]), backward_ms


# Key of a time taken by CUDA events (``_event_us``) where the profiler
# recorded no kernel of the function; EVENT_TIMED counts such times, and
# each timing phase prints how many of its own there were.
EVENTS = "cuda events"
EVENT_TIMED: list = []


def _event_us(fn, calls: int = 20) -> float:
    """Device time (us) of one call of fn from CUDA events around `calls`
    back-to-back calls queued behind a spin of the card (about 2 ms), so
    the host's launch path does not separate them. Each launch's own
    start-up on the card (about 1 us) stays in, so it reads high for a
    kernel of a few microseconds; a function that waits for the card is
    timed unqueued."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times)) * 1e3


def _device_us(fn, calls: int = 50) -> dict:
    """Device time (us) of one call of fn, by kernel, from the profiler's
    device-kernel records over `calls` calls. The host's launch path, which
    exceeds a few-microsecond kernel, is left out. The profiler on the card
    loses records: a few in a session, and now and then every record of
    several sessions in a row. So a kernel's time is the mean of its
    records times its launches a call (its records over the calls,
    rounded); a session whose counts are not whole multiples of its calls
    is taken again with fewer calls (50, 20, 10, 5) and the best one
    stands; and where none recorded a kernel the time is taken by CUDA
    events (``_event_us``, under the key EVENTS) and counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    best, best_n = {}, 0
    for n_calls in (calls, 20, 10, 5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_calls):
                fn()
            torch.cuda.synchronize()
        rows = {e.key: (e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0}
        per_call = {key: us / n * max(1, round(n / n_calls))
                    for key, (us, n) in rows.items()}
        if rows and all(n % n_calls == 0 for _, n in rows.values()):
            return per_call
        if sum(n for _, n in rows.values()) > best_n:
            best, best_n = per_call, sum(n for _, n in rows.values())
    if best:
        return best
    EVENT_TIMED.append(fn)
    return {EVENTS: _event_us(fn)}


def _device_ms_per_call(fn, calls: int = 50) -> float:
    """Device time of one call of fn, over `calls` calls."""
    return sum(_device_us(fn, calls).values()) / 1e3


def _warm_cold_ms(fn, flush, calls: int = 50) -> tuple[float, float]:
    """Device ms a call of fn with its inputs warm in L2, and cold: `flush`
    (larger than L2) written before each call, its kernel left out by
    counting only the kernels that fn launched warm. Where either was
    timed by events, both are, the cold one less the flush's own time."""
    warm = _device_us(fn, calls)

    def cold():
        flush.zero_()
        fn()

    cold_us = _device_us(cold, calls)
    if EVENTS in warm or EVENTS in cold_us:
        warm_us = warm.get(EVENTS) or _event_us(fn)
        cold_ms = (cold_us.get(EVENTS) or _event_us(cold)) \
            - _event_us(flush.zero_)
        return warm_us / 1e3, cold_ms / 1e3
    check(any(key in cold_us for key in warm),
          "the cold trace holds none of the kernels of the warm one")
    return (sum(warm.values()) / 1e3,
            sum(us for key, us in cold_us.items() if key in warm) / 1e3)


def _time_kernel(fn, plain, *, bytes_moved: int, ops: int, op_rate: float,
                 library=None) -> tuple[dict, dict]:
    """A kernel's device time a call over 50 calls, twice with the inputs
    warm in L2 and once cold (a 128 MB buffer written between calls), beside
    its bound, its plain version and the library call (None where no single
    PyTorch call computes the function; warm and cold like the kernel), and
    the event time of back-to-back calls. Returns the row of the kernels
    line and the other fields to print."""
    flush = torch.empty(2**27, dtype=torch.uint8, device="cuda")   # > L2
    event_timed = len(EVENT_TIMED)
    ms, cold_ms = _warm_cold_ms(fn, flush)
    plain_ms = _device_ms_per_call(plain)
    library_ms, library_cold_ms = (_warm_cold_ms(library, flush) if library
                                   else (None, None))
    ms2 = _device_ms_per_call(fn)
    wall_ms = median_ms(fn)
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / op_rate
    bound_ms = max(t_bytes, t_ops) * 1e3
    row = dict(ms=min(ms, ms2), plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    extra = dict(ms_runs=[ms, ms2], l2="warm", cold_l2_ms=cold_ms,
                 cold_l2_roofline_share=bound_ms / cold_ms if cold_ms > 0
                 else None,
                 library_cold_l2_ms=library_cold_ms,
                 wall_ms_per_call_back_to_back=wall_ms, bytes=bytes_moved,
                 times_by_cuda_events=len(EVENT_TIMED) - event_timed,
                 ops=ops, bytes_ms=t_bytes * 1e3, ops_ms=t_ops * 1e3,
                 roofline_share=bound_ms / row["ms"])
    return row, extra


def phase_filter_times(seed: int) -> dict:
    """The range filter at the ads scan's shape (4 columns, one 2**20-row
    group) against its bound and its plain version."""
    from repro_torch.kernels.filter import range_mask, range_mask_ref
    C, N = 4, 2**20
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((C, N), dtype=np.float32)).cuda()
    lo, hi = (torch.from_numpy(b).cuda() for b in _filter_bounds(rng, C, "gt0"))
    row, extra = _time_kernel(
        lambda: range_mask(x, lo, hi), lambda: range_mask_ref(x, lo, hi),
        bytes_moved=(4 * C + 1) * N, ops=2 * C * N,
        op_rate=F32_FLOP_PER_S)                     # two compares per value
    emit("filter_times", C=C, N=N, **extra, **row)
    return row


def phase_dequant_times(seed: int) -> dict:
    """The column-list body at the ads payload's launch shape (12 BF16
    columns of a 2**20-row group to float32: the row of the kernels line),
    beside the library call on the same codes as one [12, 2**20] tensor,
    and the host time of the entry point (pack, copy, launch, copy back,
    synchronise) at that shape; the column-list body and the [R, C] body on
    one such column (the launch the read path used to make a column at a
    time); the probe shape of benchmarks/bench_quantization.py:45 ([512,
    256] int8 to bfloat16, float32 arithmetic) and an INT16 column through
    the float64 route.
    Each reads its codes and writes its values once."""
    from repro_torch.core.quantization import QuantMode, QuantSpec, quantize
    from repro_torch.kernels.dequant import (dequant, dequant_columns,
                                             dequant_packed, dequant_packed_ref,
                                             dequant_ref, pack_columns)
    rng = np.random.default_rng(seed)
    N = 2**20
    bits = quantize(rng.normal(size=(12, N)).astype(np.float32),
                    QuantSpec(QuantMode.BF16))
    rows = {}
    for name, cols in (("ads_payload_12_bf16_columns", 12),
                       ("one_bf16_column", 1)):
        codes = list(bits[:cols])
        packed = pack_columns(codes, [(0.0, 0.0)] * cols)
        staging = packed.buffer.cuda()
        q = torch.from_numpy(bits[:cols]).cuda()
        n = cols * N
        row, extra = _time_kernel(
            lambda: dequant_packed(staging, cols, packed.n_tiles,
                                   packed.n_out),
            lambda: dequant_packed_ref(staging, cols, packed.n_out),
            bytes_moved=staging.numel() + 4 * n, ops=n,   # a shift a value
            op_rate=F32_FLOP_PER_S,
            library=lambda: q.view(torch.bfloat16).float())
        if cols == 12:
            host = []
            for _ in range(10):
                t0 = time.perf_counter()
                dequant_columns(codes, [(0.0, 0.0)] * cols, device="cuda")
                host.append(time.perf_counter() - t0)
            extra["entry_host_ms"] = float(np.median(host)) * 1e3
        emit("dequant_times", case=name, body="columns", shape=[cols, N],
             q="uint16", arith="float64", out="float32",
             library_call="q.view(torch.bfloat16).float() on [cols, 2**20]",
             kernel_over_library=row["ms"] / row["library_ms"], **extra, **row)
        rows[name] = row
    cases = [
        ("one_bf16_column_rc", torch.from_numpy(bits[0]).cuda().view(N, 1),
         torch.float64, torch.float32),
        ("bench_quantization_probe",
         torch.from_numpy(rng.integers(-128, 128, (512, 256)).astype(np.int8))
         .cuda(), torch.float32, torch.bfloat16),
        ("int16_column_f64",
         torch.from_numpy(rng.integers(-2**15, 2**15, (N, 1)).astype(np.int16))
         .cuda(), torch.float64, torch.float32),
    ]
    for name, q, arith, out_dtype in cases:
        C = q.shape[1]
        s = torch.from_numpy(rng.uniform(1e-3, 1.0, C)).to("cuda", arith)
        z = torch.from_numpy(rng.normal(size=C)).to("cuda", arith)
        out_size = torch.empty(0, dtype=out_dtype).element_size()
        bits_only = q.dtype == torch.uint16
        # a shift per value for bf16 bits, else a multiply and an add
        ops = q.numel() * (1 if bits_only else 2)
        rate = F64_FLOP_PER_S if arith == torch.float64 and not bits_only \
            else F32_FLOP_PER_S
        row, extra = _time_kernel(
            lambda: dequant(q, s, z, out_dtype),
            lambda: dequant_ref(q, s, z, out_dtype),
            bytes_moved=q.numel() * (q.element_size() + out_size)
            + (0 if bits_only else 2 * C * s.element_size()),
            ops=ops, op_rate=rate,
            library=(lambda: q.view(torch.bfloat16).float())
            if bits_only and out_dtype == torch.float32 else None)
        emit("dequant_times", case=name, body="[R, C]", shape=list(q.shape),
             q=str(q.dtype).replace("torch.", ""),
             arith=str(arith).replace("torch.", ""),
             out=str(out_dtype).replace("torch.", ""), **extra, **row)
    return rows["ads_payload_12_bf16_columns"]


def phase_bitunpack_times(seed: int) -> dict:
    """The unpack kernel on 2**24 values at widths 1, 4, 11 (the entry
    point's row of the kernels line) and 32. Each reads ceil(n / 32) * w plane
    words and writes n values once; the work is a bit extract and an insert
    per bit of each value, counted at the float32 rate outside the tensor
    cores (integer lanes)."""
    from repro_torch.kernels.bitunpack import bitunpack, bitunpack_ref
    rng = np.random.default_rng(seed)
    n, rows = 2**24, {}
    for w in (1, 4, BITUNPACK_MAIN["width"], 32):
        planes = torch.from_numpy(rng.integers(0, 2**32, (n // 32, w),
                                               dtype=np.uint64)
                                  .astype(np.uint32)).cuda()
        row, extra = _time_kernel(
            lambda: bitunpack(planes, w, n),
            lambda: bitunpack_ref(planes, w),
            bytes_moved=4 * (planes.numel() + n), ops=2 * n * w,
            op_rate=F32_FLOP_PER_S)
        emit("bitunpack_times", n=n, width=w, **extra, **row)
        rows[w] = row
    return rows[BITUNPACK_MAIN["width"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    kind = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    phase_build()
    serve_err, wide_err, train_err, window_err, family_err = \
        phase_kernels(args.seed)
    filter_err = phase_filter_kernels(args.seed)
    dequant_err = phase_dequant_kernels(args.seed)
    bitunpack_launches, bitunpack_err = phase_bitunpack_kernels(args.seed)
    model, prompts, gen, launches, decode_calls, serve_times = \
        phase_serve(args.seed)
    phase_profile(model, prompts)
    del model
    torch.cuda.empty_cache()
    phase_logits(args.seed, gen)
    row, wide = phase_times(args.seed)
    window_row = phase_window_times(args.seed)
    family_rows = phase_family_times(args.seed)
    decode_rows = phase_decode_attention(args.seed)
    t1 = time.perf_counter()
    family_launches, family_decode_calls = phase_families(args.seed)
    families_s = time.perf_counter() - t1
    filter_row = phase_filter_times(args.seed)
    dequant_row = phase_dequant_times(args.seed)
    bitunpack_row = phase_bitunpack_times(args.seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tables_")
    phase_s = {}      # host seconds of the read phases, for the time limit

    def timed(name, fn, *a):
        t1 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t1
        return out

    try:
        scan_ads = timed("scan", phase_scan, args.seed, tmp)
        unpack_row = timed("page_unpack", phase_page_unpack, args.seed)
        service_launches = timed("service", phase_service, args.seed, tmp)
        compliance_launches, victims = timed("compliance", phase_compliance,
                                             tmp)
        sink_launches = timed("sink", phase_sink, tmp, victims)
        loader_launches = timed("loader", phase_loader, args.seed, tmp)
        timed("export", phase_export, tmp)
        train = timed("train", phase_train, args.seed, tmp)
        dist = timed("distributed", phase_distributed, args.seed, tmp)
        sharded_launches, sharded_decode_calls = timed(
            "sharded_serve", phase_sharded_serve, args.seed, tmp, prompts,
            gen, serve_times)
        timed("dryrun", phase_dryrun, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    by_phase = {"scan_ads": scan_ads,
                **{f"compliance_{case}": launched for case, launched
                   in compliance_launches.items()},
                "sink": sink_launches, "loader": loader_launches,
                "service": service_launches}
    train_row, train_bwd_ms = phase_train_times(args.seed)
    print(json.dumps({"kernels": [
        dict(name="flash_attention", route="cuda", body="wgmma",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:91",
             launches=launches, max_abs_err=serve_err, **row,
             launches_by_phase={"serve": launches, "train": train["launches"],
                                "distributed": dist["flash_launches"],
                                "sharded_serve": sharded_launches,
                                 **{f"families_{arch}": n for arch, n
                                    in family_launches.items()}},
             d256=dict(body="wgmma", shape=[WIDE_CASE[k] for k in
                                            "B H Hkv S D".split()],
                       max_abs_err=wide_err["wgmma"],
                       mma_max_abs_err=wide_err["mma"], **wide),
             d256_window=dict(body="wgmma", window=GEMMA_LOCAL["window"],
                              shape=[GEMMA_LOCAL[k] for k in
                                     "B H Hkv S D".split()],
                              max_abs_err=window_err["wgmma"],
                              mma_max_abs_err=window_err["mma"],
                              **window_row),
             mla_d96=dict(body="wgmma", arch="minicpm3-4b", dv=MLA_DV,
                          shape=[MLA_CASE[k] for k in "B H Hkv S D".split()],
                          launches=family_launches["minicpm3_4b"],
                          max_abs_err=family_err["mla"]["wgmma"],
                          mma_max_abs_err=family_err["mla"]["mma"],
                          **family_rows["mla"]),
             whisper_enc=dict(body="wgmma", arch="whisper-base",
                              causal=False,
                              shape=[WHISPER_ENC[k] for k in
                                     "B H Hkv S D".split()],
                              launches=family_launches["whisper_base"],
                              max_abs_err=family_err["whisper_enc"]["wgmma"],
                              mma_max_abs_err=family_err["whisper_enc"][
                                  "mma"],
                              **family_rows["whisper_enc"]),
             rg_local=dict(body="wgmma", arch="recurrentgemma-9b",
                           window=RG_LOCAL["window"],
                           shape=[RG_LOCAL[k] for k in
                                  "B H Hkv S D".split()],
                           launches=family_launches["recurrentgemma_9b"],
                           max_abs_err=family_err["rg_local"]["wgmma"],
                           mma_max_abs_err=family_err["rg_local"]["mma"],
                           **family_rows["rg_local"]),
             train=dict(body="simt", dtype="float32",
                        shape=[TRAIN_CASE[k] for k in "B H Hkv S D".split()],
                        launches_per_step=2 * train["n_layers"],
                        max_abs_err=train_err,
                        plain_backward_ms=train_bwd_ms, **train_row)),
        dict(name="range_mask", route="cuda",
             source="src/repro_torch/csrc/filter.cu",
             replaces="src/repro/kernels/filter/kernel.py:31",
             launches=scan_ads["range_mask"], max_abs_err=float(filter_err),
             launches_by_phase={k: v["range_mask"]
                                for k, v in by_phase.items()},
             **filter_row),
        dict(name="dequant", route="cuda", body="columns",
             source="src/repro_torch/csrc/dequant.cu",
             replaces="src/repro/kernels/dequant/kernel.py:38",
             launches=scan_ads["dequant_packed"], max_abs_err=dequant_err,
             launches_by_phase={k: v["dequant_packed"]
                                for k, v in by_phase.items()},
             **dequant_row),
        dict(name="bitunpack", route="cuda",
             source="src/repro_torch/csrc/bitunpack.cu",
             replaces="src/repro/kernels/bitunpack/kernel.py:33",
             launches=bitunpack_launches, max_abs_err=bitunpack_err,
             **bitunpack_row),
        dict(name="page_unpack", route="cuda",
             source="src/repro_torch/csrc/page_unpack.cu",
             replaces="none: NumPy unpack_bits under FixedBitWidth.decode "
             "and Dictionary.decode (src/repro/core/encodings/numeric.py)",
             launches=scan_ads["page_unpack"], max_abs_err=0.0,
             launches_by_phase={k: v["page_unpack"]
                                for k, v in by_phase.items()},
             **unpack_row),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="none: the reference leaves decode attention to XLA "
             "as dot_attention (src/repro/models/transformer.py)",
             layer_calls=decode_calls,
             layer_calls_by_phase={
                 "serve": decode_calls,
                 "sharded_serve": sharded_decode_calls,
                 **{f"families_{arch}": n for arch, n
                    in family_decode_calls.items()}},
             **decode_rows)]}), flush=True)
    emit("done", seconds=time.perf_counter() - t0, read_phase_s=phase_s,
         families_s=families_s)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
