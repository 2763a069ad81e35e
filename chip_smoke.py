#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Drives the port's three main paths. Serving: full-width llama3.2-1b
(random weights from the seed, bf16) served by ``ServeEngine``: 8 prompts of
512 tokens, a prefill and 32 greedy decode steps, with prefill attention in
the hand-written flash-attention kernel. The predicate read:
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
through the same filter and dequant kernels. Phases, one JSON line each:

  1. device         -- CUDA, compute capability 9.x, the card's name and
                       power limit
  2. build          -- nvcc builds every csrc/*.cu for sm_90a, all at once
  3. kernels        -- flash attention against its plain version, 25 cases,
                       each through "auto" and through every body that
                       takes it (wgmma, mma for bf16; simt for f32); 9 of
                       them with 128 < D <= 256, where "auto" takes mma
                       (bf16) or simt (f32)
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
                       mma body at a gemma3-12b prefill (D = 256) the same
                       way
 11. filter_times   -- the range filter at C=4, N=2**20 against its bound
                       and its plain version
 12. dequant_times  -- the column-list body at the ads payload's launch
                       shape (12 BF16 columns of 2**20 rows) and on one
                       column, the [R, C] body on one column, the
                       bench_quantization probe and an INT16 column, against
                       the bound, the plain version and, for bf16 bits, the
                       PyTorch call
 13. bitunpack_times -- the unpack kernel at 2**24 values, widths 1, 4, 11
                        and 32
 14. scan           -- the read path: launch counts per scan (the filter once
                       a row group evaluated, the column-list dequant once a
                       decode call with a BF16 or affine column), results
                       equal to the NumPy route, serially and on 4 threads,
                       scan times, and the time split (host stages, device
                       copies and kernels)
 15. compliance     -- delete_where on copies of the ads table (a float32
                       range over two dense features at L2 and L1, 16 users
                       at L2): files byte-identical to the device="cpu"
                       route's, the audit, the rows left, the launches,
                       the I/O ratio and the host time of each delete
 16. sink           -- write_to of the ads query, dequantized, sorted by
                       dense_0, in shards of 2**19 rows: shards
                       byte-identical to the cpu route's, read back equal to
                       the scan sorted, the launches; the sink of an L1
                       deleted copy leaves no raw occurrence
 17. loader         -- BullionLoader(predicate=) as rank 0 and 1 of 2 against
                       the cpu loader, a mid-epoch resume, the filter's
                       launches with the loader's thread and a main-thread
                       scan reading at once, tokens per second;
                       quality_filtered_read against its cpu route
 18. export         -- Dataset.profile(path) of the ads query, BULLION_TRACE
                       in a fresh interpreter, Prometheus text round trip

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
import shutil
import subprocess
import sys
import tempfile
import time
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
    return {"flash_attention": flash_attention, "range_mask": range_mask,
            "dequant": dequant, "dequant_packed": dequant_packed,
            "bitunpack": bitunpack}


def zero_counts() -> None:
    """Every kernel's launch count to 0 (flash attention's by body too),
    just before a main path runs."""
    for fn in _launch_counters().values():
        fn.launches = 0
    from repro_torch.kernels.flash_attention import flash_attention
    for body in flash_attention.launches_by_body:
        flash_attention.launches_by_body[body] = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in _launch_counters().items()}


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
    """N(0,1) q, k, v from numpy; layout "bshd" (the model's) or "bhsd"."""
    shapes = [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)]
    out = [torch.tensor(rng.normal(size=s), dtype=dtype, device="cuda")
           for s in shapes]
    return out if layout == "bshd" else [x.transpose(1, 2).contiguous()
                                         for x in out]


SERVE_CASE = dict(B=SERVE_B, H=32, Hkv=8, S=SERVE_P, D=64,
                  dtype=torch.bfloat16, causal=True, window=0, kv_len=None,
                  layout="bshd")
# a gemma3-12b prefill (head_dim 256, 16 query and 8 kv heads) of 2 x 1024
WIDE_CASE = dict(B=2, H=16, Hkv=8, S=1024, D=256, dtype=torch.bfloat16,
                 causal=True, window=0, kv_len=None, layout="bshd")


def kernel_cases() -> list[dict]:
    base = dict(B=1, H=2, Hkv=2, causal=True, window=0, kv_len=None,
                layout="bhsd")
    cases = [dict(SERVE_CASE)]
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
    # 128 < D <= 256 (gemma3-12b, recurrentgemma-9b): mma for bf16, simt f32
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
    return cases


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


def phase_kernels(seed: int) -> tuple[float, float]:
    """The kernel vs attention_ref on the card, each case through "auto"
    and through every body that takes it; returns the wgmma body's error
    at the serving shape and the mma body's at WIDE_CASE."""
    from repro_torch.kernels.flash_attention import (attention, attention_ref,
                                                     flash_attention)
    serve_err = wide_err = None
    for i, c in enumerate(kernel_cases()):
        rng = np.random.default_rng(seed + i)
        q, k, v = _inputs(rng, c["B"], c["H"], c["Hkv"], c["S"], c["D"],
                          c["dtype"], c["layout"])
        kw = dict(causal=c["causal"], window=c["window"], kv_len=c["kv_len"])
        if c["layout"] == "bshd":
            ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), **kw)
            qs, ks, vs = q, k, v
        else:
            ref = attention_ref(q, k, v, **kw)
            qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        auto_body, bodies = _bodies(qs, ks, vs)
        if c["D"] > 128:
            want = "mma" if c["dtype"] == torch.bfloat16 else "simt"
            check(auto_body == want and "wgmma" not in bodies,
                  f"kernel case {i}: auto takes {auto_body} of {bodies}, "
                  f"expected {want} and no wgmma (D > 128)")
        elif c["dtype"] == torch.bfloat16 and c["D"] % 8 == 0:
            check(auto_body == "wgmma", f"kernel case {i}: auto takes "
                  f"{auto_body}, expected wgmma (aligned bf16, D % 8 == 0)")
        tol = TOL[c["dtype"]]
        for body in ["auto", *bodies]:
            before = dict(flash_attention.launches_by_body)
            if c["layout"] == "bshd":
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
            if c == dict(WIDE_CASE) and body == "mma":
                wide_err = err
    return serve_err, wide_err


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
    """Route the model's prefill attention through fn for one run."""
    from repro_torch.models import transformer
    saved = transformer.attention
    transformer.attention = fn
    try:
        yield saved
    finally:
        transformer.attention = saved


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
    """The main path at full width and depth, its launch count, and the
    kernel against its plain version on the q, k, v of every layer."""
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
    out = eng.generate(prompts, max_new_tokens=SERVE_NEW)      # the main path
    launched = counts()
    launches = launched["flash_attention"]
    by_body = dict(flash_attention.launches_by_body)
    check(launched == dict(flash_attention=cfg.n_layers, range_mask=0,
                           dequant=0, dequant_packed=0, bitunpack=0),
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
         flash_launches_by_body=by_body,
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
    return model, prompts, gen, launches


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


def _kernel_table(prof, top: int = 8) -> tuple[float, list]:
    """Device kernels only (host-side operator rows would count them twice)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
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


def _flash_work(B, H, Hkv, S, D, size):
    """Bytes a causal call must move (each input read once, the output
    written once) and the products of its live (query, key) pairs."""
    live_pairs = B * H * S * (S + 1) // 2
    return (2 * B * S * H + 2 * B * S * Hkv) * D * size, 4 * D * live_pairs, \
        live_pairs


def phase_times(seed: int) -> tuple[dict, dict]:
    """Flash attention at the serving shape: the wgmma body (the main
    path's) against its bound, its plain version and the library call, and
    the mma body beside it, all in device time, warm and cold in L2. Then
    the mma body at WIDE_CASE (D = 256), the same way."""
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
        lambda: attention(q, k, v, causal=True, body="mma"),
        lambda: attention_ref(qt, kt, vt, causal=True),
        bytes_moved=bytes_moved, ops=flops, op_rate=BF16_FLOP_PER_S,
        library=lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    emit("times", shape=[B, H, Hkv, S, D], dtype="bfloat16", causal=True,
         body="mma", **extra, live_scores=live_pairs,
         exp_ms=live_pairs / _mufu_ex2_per_s() * 1e3,
         mma_over_library=wide["ms"] / wide["library_ms"], **wide)
    return row, wide


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
                           dequant_packed=0, bitunpack=1),
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
             "dequant_kernel_ms": 0.0, "other_ms": 0.0}
    calls = {"filter_kernel": 0, "dequant_kernel": 0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        key = ("h2d" if "HtoD" in e.key else "d2h" if "DtoH" in e.key
               else "filter_kernel" if "range_mask" in e.key
               else "dequant_kernel" if "dequant" in e.key else "other")
        split[key + "_ms"] += ms
        if key in ("h2d", "d2h") and "Pinned" in e.key:
            split[key + "_pinned_ms"] += ms
        if key in calls:
            calls[key] += e.count
    return {**split, "kernel_calls": calls}


def phase_scan(seed: int, tmp: str) -> tuple[int, int]:
    """The predicate read path on three tables written by the port's writer
    into ``tmp`` (where the later phases find them); returns the filter's
    and the dequant kernel's launches in the ads table's serial scan."""
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
            got = ds.to_table(**kw)                     # the main path
            launched = counts()
            check(launched == dict(flash_attention=0, range_mask=groups,
                                   dequant=0, dequant_packed=want_dq,
                                   bitunpack=0),
                  f"{query} {label}: launched {launched}, expected the "
                  f"filter once for each of {groups} evaluated row "
                  f"groups and the column-list dequant {want_dq} times")
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
             launches_parallel=runs["parallel"][1],
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
    return main_launches["range_mask"], main_launches["dequant_packed"]


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
        st = delete_where(on_card, pred, Compliance(level), device="cuda")
        host_s = time.perf_counter() - t0
        got = counts()
        t0 = time.perf_counter()
        st_cpu = delete_where(on_cpu, pred, Compliance(level), device="cpu")
        cpu_s = time.perf_counter() - t0
        check(got == dict(flash_attention=0, range_mask=want_f, dequant=0,
                          dequant_packed=want_dq, bitunpack=0),
              f"compliance {case}: launched {got}, expected the filter "
              f"{want_f} times and the column-list dequant {want_dq}")
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
        with dataset(ads, device=dev) as ds:
            res = ds.where(pred).dequantized().write_to(
                out, sort_by="dense_0", shard_rows=SINK_SHARD_ROWS)
        outs[dev] = (out, res, time.perf_counter() - t0, counts())
    out, res, host_s, got = outs["cuda"]
    check(got == dict(flash_attention=0, range_mask=groups, dequant=0,
                      dequant_packed=want_dq, bitunpack=0),
          f"sink: launched {got}, expected the filter {groups} times and the "
          f"column-list dequant {want_dq}")
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
        it = iter(loader)
        batches, scans = [], 0
        for i in range(n_batches):
            batches.append(next(it))
            if i % 24 == 0:
                check(_same_table(ds.to_table(), want_scan),
                      "loader: a scan beside the loader's thread differs")
                scans += 1
        loader.close()
        got = counts()
    check(got["range_mask"] == len(reads) + scans * scan_groups and
          got["dequant_packed"] == 0,
          f"loader: launched {got} while the loader read {len(reads)} groups "
          f"and {scans} scans {scan_groups} groups each")
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
    serve_err, wide_err = phase_kernels(args.seed)
    filter_err = phase_filter_kernels(args.seed)
    dequant_err = phase_dequant_kernels(args.seed)
    bitunpack_launches, bitunpack_err = phase_bitunpack_kernels(args.seed)
    model, prompts, gen, launches = phase_serve(args.seed)
    phase_profile(model, prompts)
    del model
    torch.cuda.empty_cache()
    phase_logits(args.seed, gen)
    row, wide = phase_times(args.seed)
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
        scan_launches, dequant_launches = timed("scan", phase_scan,
                                                args.seed, tmp)
        compliance_launches, victims = timed("compliance", phase_compliance,
                                             tmp)
        sink_launches = timed("sink", phase_sink, tmp, victims)
        loader_launches = timed("loader", phase_loader, args.seed, tmp)
        timed("export", phase_export, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    by_phase = {"scan_ads": {"range_mask": scan_launches,
                             "dequant_packed": dequant_launches},
                **{f"compliance_{case}": launched for case, launched
                   in compliance_launches.items()},
                "sink": sink_launches, "loader": loader_launches}
    print(json.dumps({"kernels": [
        dict(name="flash_attention", route="cuda", body="wgmma",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:91",
             launches=launches, max_abs_err=serve_err, **row,
             d256=dict(body="mma", shape=[WIDE_CASE[k] for k in "B H Hkv S D"
                                          .split()],
                       max_abs_err=wide_err, **wide)),
        dict(name="range_mask", route="cuda",
             source="src/repro_torch/csrc/filter.cu",
             replaces="src/repro/kernels/filter/kernel.py:31",
             launches=scan_launches, max_abs_err=float(filter_err),
             launches_by_phase={k: v["range_mask"]
                                for k, v in by_phase.items()},
             **filter_row),
        dict(name="dequant", route="cuda", body="columns",
             source="src/repro_torch/csrc/dequant.cu",
             replaces="src/repro/kernels/dequant/kernel.py:38",
             launches=dequant_launches, max_abs_err=dequant_err,
             launches_by_phase={k: v["dequant_packed"]
                                for k, v in by_phase.items()},
             **dequant_row),
        dict(name="bitunpack", route="cuda",
             source="src/repro_torch/csrc/bitunpack.cu",
             replaces="src/repro/kernels/bitunpack/kernel.py:33",
             launches=bitunpack_launches, max_abs_err=bitunpack_err,
             **bitunpack_row)]}), flush=True)
    emit("done", seconds=time.perf_counter() - t0, read_phase_s=phase_s)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
