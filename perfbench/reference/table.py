"""Plain NumPy reference of a table read: what a scan or a service query
over the written table must return.

It works from the columns the generator made (never from the file the
program wrote): the deleted users' rows are dropped, the quantized
columns rounded as the configuration states, then the conjunction of
comparisons, the projection and the head applied in row order. It imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np

_OPS = {"==": np.equal, "!=": np.not_equal, "<": np.less,
        "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 (ties to even), as float32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bias = np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    out = ((bits + bias) >> np.uint32(16)) << np.uint32(16)
    nan = np.isnan(x)
    out[nan] = np.uint32(0x7FC00000)
    return out.view(np.float32)


def fp8_round(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest float8 e4m3 (PyTorch's cast), as float32:
    the next precision below BF16, for the control."""
    import torch
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.float8_e4m3fn).to(torch.float32).numpy()


ROUNDING = {"bf16": bf16_round, "fp8": fp8_round}


class TableReference:
    """The table as a reader must see it: live rows only, quantized
    columns at their stored precision."""

    def __init__(self, table: dict, quantized: list[str], victims: np.ndarray,
                 precision: str = "bf16", delete: bool = True):
        live = ~np.isin(table["user_id"], victims) if delete \
            else np.ones(len(table["user_id"]), bool)
        self.rows = np.flatnonzero(live)
        rnd = ROUNDING[precision]
        self.cols = {k: (rnd(v) if k in quantized else v)
                     for k, v in table.items()}

    def query(self, columns, where=(), head=None) -> dict:
        """``where``: a conjunction ``[[column, op, literal], ...]``."""
        keep = np.ones(len(self.rows), bool)
        for col, op, lit in where:
            keep &= _OPS[op](self.cols[col][self.rows], lit)
        rows = self.rows[keep]
        if head is not None:
            rows = rows[:head]
        return {c: self.cols[c][rows] for c in columns}


def mismatches(got: dict, want: dict) -> int:
    """Entries that differ between two results: each column compared bit
    for bit, a missing or extra row counting once a column."""
    bad = 0
    for c, w in want.items():
        g = got.get(c)
        if g is None:
            bad += len(w) or 1
            continue
        g = np.asarray(g)
        n = min(len(g), len(w))
        bad += abs(len(g) - len(w))
        if g.dtype != w.dtype:
            bad += n
            continue
        if n == 0:
            continue
        a = np.ascontiguousarray(g[:n]).view(np.uint8).reshape(n, -1)
        b = np.ascontiguousarray(w[:n]).view(np.uint8).reshape(n, -1)
        bad += int(np.count_nonzero((a != b).any(axis=1)))
    bad += sum(len(v) for c, v in got.items() if c not in want)
    return bad
