"""Plain PyTorch version of the range-filter kernel.

The kernel form of a pushed-down predicate is a per-column closed interval
(``scan.predicate.conjunctive_ranges``): a row survives iff every filter
column lies inside its interval. NaNs never survive (they fail both bound
checks). Ported from ``repro.kernels.filter.ref``; subnormals compare
exactly, as in NumPy (PyTorch does not flush them on the CPU by default).
"""

from __future__ import annotations

import torch


def range_mask_ref(cols: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor) -> torch.Tensor:
    """cols: f32[C, N]; lo, hi: f32[C] -> bool[N] conjunctive in-range mask."""
    ok = (cols >= lo.reshape(-1, 1)) & (cols <= hi.reshape(-1, 1))
    return ok.all(dim=0)
