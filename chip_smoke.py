#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Drives the port's main path: full-width llama3.2-1b (random weights from the
seed, bf16) served by ``ServeEngine``: 8 prompts of 512 tokens, a prefill
and 32 greedy decode steps, with prefill attention in the hand-written
flash-attention kernel. Phases, one JSON line each:

  1. device   -- CUDA, compute capability 9.x, the card's name and power limit
  2. build    -- nvcc builds csrc/flash_attention.cu for sm_90a
  3. kernels  -- the kernel against its plain version on the card, 14 cases
  4. serve    -- the main path, its launch count, and the kernel against
                 its plain version on the q, k, v of each of the 16 layers
  5. profile  -- device time by kernel over one prefill and 8 decode steps
  6. logits   -- at full width and one layer: prefill logits through the
                 kernel vs the plain version, decode vs a fresh prefill
  7. times    -- the kernel at the serving shape against its bound, its plain
                 version and the PyTorch library call

then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failed check raises, and the script exits non-zero without the
last line. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense: HBM3 rate and bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

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
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.load("flash_attention")
    regs = [ln.split("info    : ")[-1] for ln in built.log.splitlines()
            if "registers" in ln or "spill" in ln]
    emit("build", source="src/repro_torch/csrc/flash_attention.cu",
         build_s=built.build_s, load_s=time.perf_counter() - t0, ptxas=regs)


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
    return cases


def phase_kernels(seed: int) -> float:
    """Kernel vs attention_ref on the card; returns the serving-shape error."""
    from repro_torch.kernels.flash_attention import (attention, attention_ref,
                                                     flash_attention)
    serve_err = None
    for i, c in enumerate(kernel_cases()):
        rng = np.random.default_rng(seed + i)
        q, k, v = _inputs(rng, c["B"], c["H"], c["Hkv"], c["S"], c["D"],
                          c["dtype"], c["layout"])
        kw = dict(causal=c["causal"], window=c["window"], kv_len=c["kv_len"])
        if c["layout"] == "bshd":
            out = attention(q, k, v, **kw).transpose(1, 2)
            ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), **kw)
        else:
            out = flash_attention(q, k, v, **kw)
            ref = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[c["dtype"]]
        emit("kernels", case=i, shape=[c["B"], c["H"], c["Hkv"], c["S"], c["D"]],
             dtype=str(c["dtype"]).replace("torch.", ""), layout=c["layout"],
             **kw, max_abs_err=err, tol=tol)
        check(math.isfinite(err) and err < tol,
              f"kernel case {i} error {err} >= {tol}")
        if i == 0:
            serve_err = err
    return serve_err


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
    flash_attention.launches = 0
    out = eng.generate(prompts, max_new_tokens=SERVE_NEW)      # the main path
    launches = flash_attention.launches
    check(launches == cfg.n_layers,
          f"prefill launched the kernel {launches} times, "
          f"expected {cfg.n_layers}")
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


def phase_times(seed: int) -> dict:
    from repro_torch.kernels.flash_attention import attention, attention_ref
    c = SERVE_CASE
    B, H, Hkv, S, D = c["B"], c["H"], c["Hkv"], c["S"], c["D"]
    q, k, v = _inputs(np.random.default_rng(seed), B, H, Hkv, S, D,
                      c["dtype"], "bshd")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = median_ms(lambda: attention(q, k, v, causal=True))
    plain_ms = median_ms(lambda: attention_ref(qt, kt, vt, causal=True))
    library_ms = median_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                        enable_gqa=True))
    ms2 = median_ms(lambda: attention(q, k, v, causal=True))
    # least time for the same work: each input read once, the output written
    # once; the causal products of the live (query, key) pairs of this run
    size = q.element_size()
    bytes_moved = (2 * q.numel() + k.numel() + v.numel()) * size
    live_pairs = B * H * S * (S + 1) // 2
    flops = 4 * D * live_pairs
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    row = dict(ms=min(ms, ms2), plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops
               else "operations")
    emit("times", shape=[B, H, Hkv, S, D], dtype="bfloat16", causal=True,
         ms_runs=[ms, ms2], bytes=bytes_moved, flops=flops,
         bytes_ms=t_bytes * 1e3, ops_ms=t_ops * 1e3,
         roofline_share=bound_ms / row["ms"], **row)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    kind = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    phase_build()
    serve_err = phase_kernels(args.seed)
    model, prompts, gen, launches = phase_serve(args.seed)
    phase_profile(model, prompts)
    del model
    torch.cuda.empty_cache()
    phase_logits(args.seed, gen)
    row = phase_times(args.seed)
    print(json.dumps({"kernels": [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:91",
        launches=launches, max_abs_err=serve_err, **row)]}), flush=True)
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
