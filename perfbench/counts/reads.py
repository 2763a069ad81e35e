"""Bytes the read path's kernels must move, counted from the benchmark's
own knowledge of the table (each input byte read once, each output byte
written once). The formulas are those of ``chip_smoke.py``'s callers of
``_time_kernel`` for the filter (``[C, N]`` f32 in, a byte a row out) and
the column-list dequant (codes in, f32 out), frozen here."""

BF16_CODE_BYTES = 2
F32_BYTES = 4


def filter_bytes(n_cols: int, rows: int) -> int:
    """``range_mask`` over ``[n_cols, rows]`` f32: the block read once, one
    mask byte a row written once."""
    return n_cols * rows * F32_BYTES + rows


def dequant_bytes(n_cols: int, rows: int, code_bytes: int = BF16_CODE_BYTES) -> int:
    """The column-list dequant of ``n_cols`` columns of ``rows`` codes:
    codes read once, f32 written once."""
    return n_cols * rows * (code_bytes + F32_BYTES)
