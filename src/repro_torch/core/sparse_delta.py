"""Long-sequence sparse-feature delta encoding (Bullion §2.2, Figs. 3-4).

``clk_seq_cids``-style features are ``list<int64>`` vectors sorted by
(user, timestamp); consecutive vectors overlap in a *sliding window*: a few
new ids enter at the head, old ids fall off the tail.  Per row we store

    <delta bit> <delta range (start, len) into previous row>
    <len(head), head data> <len(tail), tail data>

with delta_bit=0 rows storing the full base vector.  Metadata/index arrays are
bit-packed/varint-cascaded; bulk id data is cascaded (typically chunked/zstd),
matching Fig. 4's on-disk layout (metadata + indexes first, bulk data after).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from .encodings import EncodeContext, decode_blob, encode_array
from .encodings.numeric import _cat, _split2

MAX_SEARCH = 32  # max head length / window start probed per row


def _best_overlap(prev: np.ndarray, cur: np.ndarray) -> tuple[int, int, int]:
    """Longest contiguous run cur[i_cur:i_cur+L] == prev[i_prev:i_prev+L].

    Returns (i_cur, i_prev, L); (0, 0, 0) when nothing useful matches.
    Search is restricted to small head offsets (the sliding-window pattern):
    new ids are prepended, the window into prev starts near its head.
    """
    best = (0, 0, 0)
    np_len, nc_len = len(prev), len(cur)
    if np_len == 0 or nc_len == 0:
        return best

    def probe(i_cur: int, i_prev: int) -> None:
        nonlocal best
        span = min(np_len - i_prev, nc_len - i_cur)
        if span <= best[2]:
            return
        neq = np.flatnonzero(cur[i_cur:i_cur + span] != prev[i_prev:i_prev + span])
        run = span if len(neq) == 0 else int(neq[0])
        if run > best[2]:
            best = (i_cur, i_prev, run)

    # the sliding-window pattern is one-sided: either new ids were prepended
    # (window starts at prev[0], head of length i_cur) or ids were dropped
    # from the head (window starts inside prev, no head).
    for i_cur in range(min(MAX_SEARCH, nc_len)):
        probe(i_cur, 0)
    for i_prev in range(1, min(MAX_SEARCH, np_len)):
        probe(0, i_prev)
    return best


def encode_page(rows: list[np.ndarray], ctx: EncodeContext | None = None) -> bytes:
    """Encode a page of list<int64> rows with sliding-window delta."""
    ctx = ctx or EncodeContext()
    n = len(rows)
    delta_bit = np.zeros(n, bool)
    win_start = np.zeros(n, np.uint32)   # i_prev
    win_len = np.zeros(n, np.uint32)     # L
    head_len = np.zeros(n, np.uint32)    # i_cur
    tail_len = np.zeros(n, np.uint32)
    row_len = np.asarray([len(r) for r in rows], np.uint32)
    bulk: list[np.ndarray] = []

    prev: np.ndarray | None = None
    for i, cur in enumerate(rows):
        cur = np.asarray(cur, np.int64)
        if prev is not None:
            i_cur, i_prev, L = _best_overlap(prev, cur)
            if L >= max(8, len(cur) // 4):  # profitable overlap
                delta_bit[i] = True
                win_start[i], win_len[i] = i_prev, L
                head_len[i] = i_cur
                tail_len[i] = len(cur) - i_cur - L
                bulk.append(cur[:i_cur])            # head data
                bulk.append(cur[i_cur + L:])        # tail data
                prev = cur
                continue
        bulk.append(cur)                            # base vector
        prev = cur

    meta_blobs = [
        encode_array(delta_bit, ctx.child()),
        encode_array(win_start, ctx.child()),
        encode_array(win_len, ctx.child()),
        encode_array(head_len, ctx.child()),
        encode_array(tail_len, ctx.child()),
        encode_array(row_len, ctx.child()),
    ]
    bulk_vals = np.concatenate(bulk) if bulk else np.zeros(0, np.int64)
    bulk_blob = encode_array(bulk_vals, ctx.child())

    payload = b"".join(struct.pack("<Q", len(b)) + b for b in meta_blobs)
    payload += struct.pack("<Q", len(bulk_blob)) + bulk_blob
    return struct.pack("<Q", n) + payload


def decode_page(blob: bytes | memoryview) -> list[np.ndarray]:
    mv = memoryview(blob)
    (n,) = struct.unpack_from("<Q", mv)
    off = 8
    parts = []
    for _ in range(7):
        (ln,) = struct.unpack_from("<Q", mv, off)
        parts.append(mv[off + 8: off + 8 + ln])
        off += 8 + ln
    delta_bit = decode_blob(parts[0]).astype(bool)
    win_start = decode_blob(parts[1]).astype(np.int64)
    win_len = decode_blob(parts[2]).astype(np.int64)
    head_len = decode_blob(parts[3]).astype(np.int64)
    tail_len = decode_blob(parts[4]).astype(np.int64)
    row_len = decode_blob(parts[5]).astype(np.int64)
    bulk = decode_blob(parts[6]).astype(np.int64)

    rows: list[np.ndarray] = []
    b = 0
    prev: np.ndarray | None = None
    for i in range(n):
        if not delta_bit[i]:
            cur = bulk[b:b + row_len[i]]
            b += row_len[i]
        else:
            head = bulk[b:b + head_len[i]]
            b += head_len[i]
            tail = bulk[b:b + tail_len[i]]
            b += tail_len[i]
            window = prev[win_start[i]:win_start[i] + win_len[i]]
            cur = np.concatenate([head, window, tail])
        rows.append(cur)
        prev = cur
    return rows


@dataclass
class SyntheticClickSeq:
    """Generator reproducing Fig. 3's sliding-window click sequences."""

    seq_len: int = 256
    id_range: int = 1 << 20
    new_per_step_max: int = 4

    def generate(self, n_rows: int, seed: int = 0) -> list[np.ndarray]:
        rng = np.random.default_rng(seed)
        cur = rng.integers(0, self.id_range, self.seq_len).astype(np.int64)
        rows = [cur.copy()]
        for _ in range(n_rows - 1):
            k = int(rng.integers(0, self.new_per_step_max + 1))
            new = rng.integers(0, self.id_range, k).astype(np.int64)
            cur = np.concatenate([new, cur])[: self.seq_len]
            rows.append(cur.copy())
        return rows
