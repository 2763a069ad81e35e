"""The port's range filter on the CPU, held against the JAX package's Pallas
kernel (interpret mode) and its NumPy oracle. Masks are compared exactly.

A case with a subnormal bound or value is held against the oracle
``range_mask_ref`` only: the Pallas kernel in interpret mode on the CPU
flushes subnormals to zero, so ``C("x") > 0`` (which ``_f32_shrink`` turns
into ``lo = 1e-45``) passes ``x = 0`` there. The port follows the NumPy
semantics, which ``repro.dataset.executor._f32_shrink`` promises (a fault of
the reference, logged in ROADMAP.md §3).
"""

import sys
import threading

import numpy as np
import pytest
import torch

from repro.dataset.executor import eval_mask as jax_eval_mask
from repro.kernels.filter import range_mask as jax_range_mask
from repro.kernels.filter import range_mask_ref as np_range_mask_ref
from repro.scan import C as jax_C
from repro.scan import evaluate as jax_evaluate
from repro_torch.dataset.executor import eval_mask
from repro_torch.kernels.filter import ops as filter_ops
from repro_torch.kernels.filter import range_mask, range_mask_ref
from repro_torch.kernels.filter.kernel import range_mask_fwd
from repro_torch.scan import C

SPECIALS = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)
SUBNORMALS = np.array([1e-45, -1e-45, 1e-40, -1e-40, 1.1754942e-38],
                      np.float32)


def _cols(seed, C_, N, subnormals=False):
    """N(0,1) columns with NaN, ±inf, ±0 (and subnormals) scattered in."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C_, N)).astype(np.float32)
    pool = np.concatenate([SPECIALS, SUBNORMALS]) if subnormals else SPECIALS
    hit = rng.random((C_, N)) < 0.1
    x[hit] = rng.choice(pool, int(hit.sum()))
    return x


def _bounds(kind, C_, seed):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1.5, 0.0, C_).astype(np.float32)
    hi = rng.uniform(0.0, 1.5, C_).astype(np.float32)
    if kind == "inf":            # half-open and unbounded intervals
        lo[::2], hi[1::2] = -np.inf, np.inf
        lo[-1], hi[-1] = -np.inf, np.inf
    elif kind == "empty":        # lo > hi in the last column: nothing passes
        lo[-1], hi[-1] = 1.0, -1.0
    elif kind == "zero":         # [0, 0]: ±0 pass, nothing else
        lo[0], hi[0] = 0.0, 0.0
    elif kind == "gt0":          # C("x") > 0 after _f32_shrink
        lo[0], hi[0] = np.float32(1e-45), np.inf
    return lo, hi


def _port(cols, lo, hi):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (cols, lo, hi)]
    out = range_mask(*t, device="cpu")
    assert out.dtype == torch.bool and out.shape == (cols.shape[1],)
    return out.numpy()


@pytest.mark.parametrize("C_", [1, 2, 4, 8])
@pytest.mark.parametrize("N", [1, 2047, 2049, 5003])
@pytest.mark.parametrize("kind", ["plain", "inf", "empty", "zero"])
def test_matches_pallas_kernel_and_oracle(C_, N, kind):
    cols = _cols(C_ * 1000 + N, C_, N)
    lo, hi = _bounds(kind, C_, N)
    got = _port(cols, lo, hi)
    assert np.array_equal(got, np.asarray(jax_range_mask(cols, lo, hi)))
    assert np.array_equal(got, np_range_mask_ref(cols, lo, hi))
    if kind == "empty":
        assert not got.any()


@pytest.mark.parametrize("C_", [1, 2, 4, 8])
@pytest.mark.parametrize("N", [1, 2049])
@pytest.mark.parametrize("kind", ["plain", "inf", "gt0"])
def test_subnormals_match_oracle(C_, N, kind):
    """Subnormal values and bounds: the NumPy oracle only (see module doc)."""
    cols = _cols(C_ + N, C_, N, subnormals=True)
    lo, hi = _bounds(kind, C_, N)
    assert np.array_equal(_port(cols, lo, hi), np_range_mask_ref(cols, lo, hi))


@pytest.mark.parametrize("view", ["rows", "cols"])
def test_strided_view(view):
    """A non-contiguous [C, N] view: every other row or column of a block."""
    big = _cols(7, 8, 4098)
    cols = big[::2] if view == "rows" else big[:4, 1::2]
    lo, hi = _bounds("inf", cols.shape[0], 3)
    t = torch.from_numpy(big)
    tv = t[::2] if view == "rows" else t[:4, 1::2]
    assert not tv.is_contiguous()
    got = range_mask(tv, torch.from_numpy(lo), torch.from_numpy(hi),
                     device="cpu").numpy()
    assert np.array_equal(got, np_range_mask_ref(cols, lo, hi))
    assert np.array_equal(got, np.asarray(jax_range_mask(cols, lo, hi)))


def test_plain_version_is_the_oracle():
    cols = _cols(11, 3, 777, subnormals=True)
    lo, hi = _bounds("gt0", 3, 1)
    got = range_mask_ref(*(torch.from_numpy(a) for a in (cols, lo, hi)))
    assert np.array_equal(got.numpy(), np_range_mask_ref(cols, lo, hi))


def test_cpu_route_launches_nothing_and_checks_devices():
    cols = torch.zeros((2, 10))
    before = range_mask.launches
    range_mask(cols, torch.zeros(2), torch.ones(2), device="cpu")
    assert range_mask.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        range_mask_fwd(cols, torch.zeros(2), torch.ones(2),
                       torch.empty(10, dtype=torch.uint8))


X_GT0 = np.array([0.0, -0.0, 1e-45, 1e-40, np.nan, 1.0, -1e-45], np.float32)


def test_gt_zero_follows_numpy_semantics():
    """``C("x") > 0``: the port's kernel route equals NumPy ``evaluate``;
    the reference's kernel route (interpret mode) flushes subnormals."""
    want = jax_evaluate(jax_C("x") > 0, {"x": X_GT0})
    assert want.tolist() == [False, False, True, True, False, True, False]
    got = eval_mask(C("x") > 0, {"x": X_GT0}, True, "cpu")
    assert got.dtype == bool and np.array_equal(got, want)
    flushed = jax_eval_mask(jax_C("x") > 0, {"x": X_GT0}, True)
    assert flushed.tolist() == [True, True, True, True, False, True, True]


@pytest.mark.parametrize("use_kernel", [None, True, False])
def test_eval_mask_matches_reference_routes(use_kernel):
    rng = np.random.default_rng(5)
    tbl = {"a": _cols(1, 1, 3000)[0], "b": _cols(2, 1, 3000)[0],
           "i": rng.integers(0, 10, 3000)}
    pred = (C("a") > -0.25) & (C("b") <= 0.5) & (C("a") < 1.0)
    ref_pred = (jax_C("a") > -0.25) & (jax_C("b") <= 0.5) & (jax_C("a") < 1.0)
    got = eval_mask(pred, tbl, use_kernel, "cpu")
    assert np.array_equal(got, jax_eval_mask(ref_pred, tbl, use_kernel))
    # an integer column does not fit the kernel: NumPy, or an error
    ipred = (C("i") >= 3) & (C("a") > 0)
    if use_kernel:
        with pytest.raises(ValueError, match="float32"):
            eval_mask(ipred, tbl, True, "cpu")
    else:
        assert np.array_equal(
            eval_mask(ipred, tbl, use_kernel, "cpu"),
            jax_eval_mask((jax_C("i") >= 3) & (jax_C("a") > 0), tbl,
                          use_kernel))


def test_launch_count_loses_no_update_across_threads():
    """The read path launches from a thread pool: the count is locked."""
    before = range_mask.launches
    threads = [threading.Thread(target=lambda: [
        filter_ops._count_launch() for _ in range(2000)]) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert range_mask.launches == before + 16 * 2000
    range_mask.launches = before
