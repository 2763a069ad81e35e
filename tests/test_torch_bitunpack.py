"""The port's BP32 pack and unpack on the CPU, held against the JAX package's
``repro.kernels.bitunpack`` (the Pallas kernel in interpret mode, and its
NumPy oracle). Tolerance: none; every value is compared exactly.
"""

import numpy as np
import pytest
import torch

from repro.kernels.bitunpack import bitunpack as jax_bitunpack
from repro.kernels.bitunpack import bitunpack_ref as np_bitunpack_ref
from repro.kernels.bitunpack import pack_bp32 as jax_pack_bp32
from repro.kernels.bitunpack import pack_bp32_ref as np_pack_bp32_ref
from repro_torch.kernels.bitunpack import (bitunpack, bitunpack_ref,
                                           pack_bp32, pack_bp32_ref)
from repro_torch.kernels.bitunpack.kernel import bitunpack_fwd


def _values(width, n, seed):
    """The draw of tests/test_kernels.py::test_bitunpack_widths."""
    rng = np.random.default_rng(seed)
    hi = (1 << width) - 1 if width < 32 else 0xFFFFFFFF
    return (rng.integers(0, 1 << 31, n) & hi).astype(np.uint32)


@pytest.mark.parametrize("width", [1, 7, 11, 31, 32])
@pytest.mark.parametrize("n", [1, 31, 32 * 256])
def test_matches_pallas_kernel(width, n):
    vals = _values(width, n, width)
    planes = pack_bp32(vals, width)
    assert planes.dtype == np.uint32
    assert np.array_equal(planes, jax_pack_bp32(vals, width))
    got = bitunpack(planes, width, n_values=n, device="cpu")
    assert got.dtype == torch.uint32 and got.shape == (n,)
    assert np.array_equal(got.numpy(), vals)
    assert np.array_equal(
        got.numpy(), np.asarray(jax_bitunpack(planes, width, n_values=n)))


@pytest.mark.parametrize("width", range(1, 33))
def test_every_width_matches_oracle(width):
    """Random plane words (any uint32), so every bit of every plane is
    exercised, against the reference's NumPy oracle."""
    rng = np.random.default_rng(100 + width)
    planes = rng.integers(0, 2**32, (37, width), dtype=np.uint64) \
        .astype(np.uint32)
    got = bitunpack(torch.from_numpy(planes), width, device="cpu")
    assert np.array_equal(got.numpy(), np_bitunpack_ref(planes, width))
    assert np.array_equal(bitunpack_ref(torch.from_numpy(planes), width)
                          .numpy(), np_bitunpack_ref(planes, width))


@pytest.mark.parametrize("width", [3, 16, 32])
def test_pack_equals_reference(width):
    vals = _values(width, 32 * 40, 7)
    assert np.array_equal(pack_bp32_ref(vals, width),
                          np_pack_bp32_ref(vals, width))
    vals = _values(width, 5000, 8)                   # padded to 8192 values
    planes = pack_bp32(vals, width)
    assert planes.shape == (256, width)
    assert np.array_equal(planes, jax_pack_bp32(vals, width))


def test_ragged_length():
    """tests/test_kernels.py::test_bitunpack_ragged_length."""
    rng = np.random.default_rng(0)
    n = 32 * 256 + 7 * 32
    vals = rng.integers(0, 1 << 11, n).astype(np.uint32)
    planes = pack_bp32(vals, 11)
    assert planes.shape == (512, 11)
    got = bitunpack(planes, 11, n_values=n, device="cpu")
    assert np.array_equal(got.numpy(), vals)
    assert np.array_equal(got.numpy(), np.asarray(
        jax_bitunpack(planes, 11, n_values=n)))


def test_strided_planes():
    rng = np.random.default_rng(3)
    big = rng.integers(0, 2**32, (64, 32), dtype=np.uint64).astype(np.uint32)
    view = torch.from_numpy(big)[:, :12]
    assert not view.is_contiguous()
    got = bitunpack(view, 12, n_values=1000, device="cpu")
    assert np.array_equal(got.numpy(),
                          np_bitunpack_ref(np.ascontiguousarray(big[:, :12]),
                                           12)[:1000])


def test_checks_and_cpu_route_launches_nothing():
    planes = torch.zeros((2, 5), dtype=torch.uint32)
    before = bitunpack.launches
    assert bitunpack(planes, 5, device="cpu").shape == (64,)
    assert bitunpack(planes, 5, 0, device="cpu").shape == (0,)
    assert bitunpack.launches == before
    with pytest.raises(ValueError, match="width"):
        bitunpack(planes, 4, device="cpu")
    with pytest.raises(ValueError, match="uint32"):
        bitunpack(planes.to(torch.int32), 5, device="cpu")
    with pytest.raises(ValueError, match="n_values"):
        bitunpack(planes, 5, 65, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        bitunpack_fwd(planes, 5, torch.empty(64, dtype=torch.uint32))
