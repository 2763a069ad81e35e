"""Tests of the port that need the card: the flash-attention and range-filter
kernels against their plain versions, the smoke model on CUDA against the
CPU, and a predicate read on CUDA against the CPU. They skip where CUDA is
absent. On an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import repro_torch.configs as configs
from repro_torch.data import write_ads_table
from repro_torch.dataset import dataset
from repro_torch.kernels.filter import range_mask, range_mask_ref
from repro_torch.kernels.flash_attention import (attention, attention_ref,
                                                 flash_attention)
from repro_torch.scan import C
from repro_torch.models.zoo import build

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}   # tests/test_kernels.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,kv_len", [
    (2, 8, 2, 256, 64, True, 0, None),
    (1, 2, 2, 200, 80, True, 0, None),
    (1, 4, 4, 256, 64, True, 64, None),
    (2, 4, 1, 256, 64, False, 0, 130),
    (1, 2, 2, 96, 100, True, 0, 70),
])
def test_kernel_matches_plain(cuda, dtype, B, H, Hkv, S, D, causal, window,
                              kv_len):
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=dtype, device=cuda)
               for s in [(B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)])
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, causal=causal, window=window, kv_len=kv_len)
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


def test_kernel_takes_strided_model_layout(cuda):
    """[B, S, H, D] views of a fused projection, as the model may give."""
    rng = np.random.default_rng(1)
    B, S, H, Hkv, D = 2, 128, 4, 2, 64
    qkv = torch.tensor(rng.normal(size=(B, S, (H + 2 * Hkv) * D)),
                       dtype=torch.bfloat16, device=cuda)
    q = qkv[..., :H * D].unflatten(-1, (H, D))
    k = qkv[..., H * D:(H + Hkv) * D].unflatten(-1, (Hkv, D))
    v = qkv[..., (H + Hkv) * D:].unflatten(-1, (Hkv, D))
    out = attention(q, k, v)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2)).transpose(1, 2)
    assert (out.float() - ref.float()).abs().max().item() < 3e-2


def test_smoke_model_on_cuda_matches_cpu(cuda):
    cfg = configs.get_smoke("llama3.2-1b").scaled(compute_dtype="float32")
    cpu_model = build(cfg, device="cpu")
    gpu_model = build(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    tok = torch.tensor(np.random.default_rng(2).integers(0, cfg.vocab, (2, 40)))
    with torch.inference_mode():
        ref, _ = cpu_model.prefill({"tokens": tok}, cpu_model.init_cache(2, 48))
        before = flash_attention.launches
        out, _ = gpu_model.prefill({"tokens": tok.to(cuda)},
                                   gpu_model.init_cache(2, 48))
    assert flash_attention.launches == before + cfg.n_layers
    scale = ref.abs().max().item()
    assert (out.cpu() - ref).abs().max().item() < 1e-4 * scale + 1e-5


def _filter_inputs(seed, C_, N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C_, N)).astype(np.float32)
    pool = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45,
                     1e-40], np.float32)
    hit = rng.random((C_, N)) < 0.1
    x[hit] = rng.choice(pool, int(hit.sum()))
    lo = rng.uniform(-1.5, 0.0, C_).astype(np.float32)
    hi = rng.uniform(0.0, 1.5, C_).astype(np.float32)
    lo[0] = np.float32(1e-45)                   # C("x") > 0
    return x, lo, hi


@pytest.mark.parametrize("C_", [1, 3, 4, 8])
@pytest.mark.parametrize("N", [1, 2047, 2049, 100_003])
def test_range_mask_bit_identical(cuda, C_, N):
    x, lo, hi = _filter_inputs(C_ * 7 + N, C_, N)
    t = [torch.from_numpy(a).to(cuda) for a in (x, lo, hi)]
    before = range_mask.launches
    got = range_mask(*t)
    torch.cuda.synchronize()
    assert range_mask.launches == before + 1
    assert torch.equal(got, range_mask_ref(*t))
    assert torch.equal(got.cpu(), range_mask_ref(
        *(torch.from_numpy(a) for a in (x, lo, hi))))


def test_range_mask_strided_view(cuda):
    x, lo, hi = _filter_inputs(3, 8, 10_001)
    big = torch.from_numpy(x).to(cuda)
    for view in (big[::2], big[:4, 1::2], big[:, 3:]):
        n_c = view.shape[0]
        lo_t = torch.from_numpy(lo[:n_c]).to(cuda)
        hi_t = torch.from_numpy(hi[:n_c]).to(cuda)
        assert torch.equal(range_mask(view, lo_t, hi_t),
                           range_mask_ref(view, lo_t, hi_t))


def test_predicate_read_on_cuda_matches_cpu(cuda, tmp_path):
    path = str(tmp_path / "ads.bln")
    write_ads_table(path, n_rows=8192, n_sparse=0, n_dense=4,
                    rows_per_group=2048)
    pred = (C("dense_0") > 0) & (C("dense_1") <= 1.0)
    ds = dataset(path, device="cuda").select(["ts", "dense_0"]).where(pred)
    before = range_mask.launches
    got = ds.to_table(parallelism=2)
    assert range_mask.launches == before + len(ds.physical_plan().tasks)
    want = dataset(path, device="cpu").select(["ts", "dense_0"]) \
        .where(pred)._with_kernel(False).to_table()
    for k in want:
        assert np.array_equal(got[k], want[k])
