"""Sampling-based cascading encoder selection (Bullion §2.6).

BtrBlocks-style: estimate each candidate on contiguous samples, pick the one
minimizing a Nimble-style weighted objective (size + encode time + decode
time), recurse into subcolumns up to ``ctx.max_depth``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .base import BY_NAME, EncodeContext, Encoding, decode_blob, unframe
from . import numeric, floats, bytes_  # noqa: F401  (registration side effects)

# candidate order per column kind; order breaks ties deterministically
INT_CANDIDATES = ("constant", "rle", "dictionary", "for", "fixed_bit_width",
                  "varint", "mainly_constant", "bitshuffle", "chunked", "trivial")
FLOAT_CANDIDATES = ("constant", "rle", "dictionary", "alp_decimal", "xor_float",
                    "mainly_constant", "bitshuffle", "chunked", "trivial")
BOOL_CANDIDATES = ("constant", "rle", "sparse_bool", "trivial")
# at max depth only terminal (non-recursive) encodings are allowed
TERMINAL = ("constant", "fixed_bit_width", "for", "varint", "chunked", "trivial",
            "sparse_bool")
BYTES_CANDIDATES = ("fsst_lite", "raw_bytes")


def _candidates_for(arr: np.ndarray, ctx: EncodeContext) -> tuple[str, ...]:
    if ctx.candidates is not None:
        return ctx.candidates
    if arr.dtype.kind == "b":
        names = BOOL_CANDIDATES
    elif arr.dtype.kind == "f":
        names = FLOAT_CANDIDATES
    else:
        names = INT_CANDIDATES
    if ctx.depth >= ctx.max_depth:
        names = tuple(n for n in names if n in TERMINAL)
    return names


def _sample(arr: np.ndarray, ctx: EncodeContext) -> np.ndarray:
    n = len(arr)
    if n <= ctx.sample_size * 2:
        return arr
    # BtrBlocks samples contiguous runs, not random points, so run-structure
    # (RLE/delta-friendliness) survives sampling.
    k = 4
    run = max(ctx.sample_size // k, 1)
    starts = np.linspace(0, n - run, k).astype(np.int64)
    return np.concatenate([arr[s:s + run] for s in starts])


def _objective(enc: Encoding, sample: np.ndarray, ctx: EncodeContext) -> Optional[float]:
    try:
        t0 = time.perf_counter()
        blob = enc.encode(sample, ctx)
        t_enc = time.perf_counter() - t0
    except Exception:
        return None
    if blob is None:
        return None
    t_dec = 0.0
    if ctx.weights.decode_time:
        eid, header, payload, _ = unframe(blob)
        t0 = time.perf_counter()
        enc.decode(header, payload)
        t_dec = time.perf_counter() - t0
    per_val = len(blob) / max(len(sample), 1)
    return (ctx.weights.size * per_val
            + ctx.weights.encode_time * t_enc
            + ctx.weights.decode_time * t_dec)


def advise_candidates(rec, n: int, dtype) -> Optional[tuple[str, ...]]:
    """LEA-style statistics-driven candidate restriction.

    ``rec`` is a zone-map record (``scan.stats.STAT_DTYPE``: min/max/
    null_count/distinct — exactly the features LEA trains its advisor on).
    Where the statistics already determine the encoding family, the cascade
    skips sampling trials of encodings they rule out; returns None when the
    stats don't discriminate (full sampling-based selection). Sound either
    way — selection quality, never correctness, is at stake.
    """
    if rec is None or n == 0:
        return None
    from ...scan.stats import HAS_MINMAX
    if not int(rec["flags"]) & HAS_MINMAX:
        return None
    distinct = int(rec["distinct"])
    if distinct <= 1 and not int(rec["null_count"]):
        return ("constant", "rle", "trivial")
    if distinct and distinct <= max(16, n // 256):
        # run/dictionary territory: skip bit-width and float-codec trials
        return ("constant", "rle", "dictionary", "mainly_constant", "for",
                "fixed_bit_width", "trivial")
    if np.dtype(dtype).kind in "iu":
        span = float(rec["max"]) - float(rec["min"])
        if span < float(2 ** 20):
            if distinct >= n:
                # all-unique narrow range (ids, timestamps): run and
                # dictionary structure is provably absent — bit-level codecs
                return ("bitshuffle", "for", "fixed_bit_width", "varint",
                        "chunked", "trivial")
            # narrow integer range: frame-of-reference / bit-packing family
            return ("for", "fixed_bit_width", "rle", "dictionary", "varint",
                    "trivial")
    return None


def choose_encoding(arr: np.ndarray, ctx: Optional[EncodeContext] = None) -> str:
    ctx = ctx or EncodeContext()
    sample = _sample(arr, ctx)
    best_name, best_cost = "trivial", float("inf")
    for name in _candidates_for(arr, ctx):
        enc = BY_NAME[name]
        if not enc.applicable(arr, ctx):
            continue
        cost = _objective(enc, sample, ctx)
        if cost is not None and cost < best_cost:
            best_name, best_cost = name, cost
    return best_name


def encode_array(arr: np.ndarray, ctx: Optional[EncodeContext] = None) -> bytes:
    """Cascading entry point: pick best encoding by sampling, encode fully."""
    ctx = ctx or EncodeContext()
    arr = np.asarray(arr)
    if arr.ndim != 1:
        raise ValueError("encode_array expects a 1-D column chunk")
    name = choose_encoding(arr, ctx)
    blob = BY_NAME[name].encode(arr, ctx)
    if blob is None:  # sampling said yes but full data said no -> fall back
        blob = BY_NAME["trivial"].encode(arr, ctx)
    # last-resort guard: never ship something bigger than trivial + slack
    if name != "trivial" and len(blob) > arr.nbytes + 64:
        blob = BY_NAME["trivial"].encode(arr, ctx)
    return blob


def encode_bytes(data: bytes, ctx: Optional[EncodeContext] = None) -> bytes:
    """Select between byte-level encodings for raw string data."""
    ctx = ctx or EncodeContext()
    best_blob, best_len = None, float("inf")
    for name in BYTES_CANDIDATES:
        enc = BY_NAME[name]
        try:
            blob = enc.encode(data, ctx)
        except Exception:
            blob = None
        if blob is not None and len(blob) < best_len:
            best_blob, best_len = blob, len(blob)
    assert best_blob is not None  # raw_bytes always succeeds
    return best_blob


__all__ = ["advise_candidates", "encode_array", "encode_bytes",
           "choose_encoding", "decode_blob"]
