"""The port's flash-attention wrappers and plain version on the CPU, held
against the JAX package's Pallas kernel (interpret mode) and its oracles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.models.layers import dot_attention as jax_dot_attention
from repro_torch.kernels.flash_attention import (attention, attention_ref,
                                                 flash_attention)
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd

TOL = 3e-5   # f32, as tests/test_kernels.py


def _qkv(seed, B, H, Hkv, S, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, S, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, D)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("shape,causal,window", [
    ((2, 2, 256, 64), True, 0),
    ((1, 2, 384, 128), True, 0),
    ((1, 1, 256, 64), False, 0),
    ((2, 1, 256, 64), True, 64),
    ((1, 1, 200, 80), True, 0),       # ragged S and D
    ((1, 2, 160, 256), True, 0),      # D = 256 (gemma3-12b's heads)
    ((1, 1, 96, 200), False, 0),      # D = 200: padded to 256 there
])
def test_mha_matches_pallas_kernel(shape, causal, window):
    B, H, S, D = shape
    q, k, v = _qkv(0, B, H, H, S, D)
    ref_kernel = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, interpret=True))
    ref_oracle = np.asarray(jax_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    tq, tk, tv = _t(q, k, v)
    out = flash_attention(tq, tk, tv, causal=causal, window=window,
                          device="cpu").numpy()
    plain = attention_ref(tq, tk, tv, causal=causal, window=window).numpy()
    assert out.shape == shape
    assert np.abs(out - ref_kernel).max() < TOL
    assert np.abs(out - ref_oracle).max() < TOL
    assert np.abs(plain - ref_oracle).max() < TOL


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,kv_len", [
    (2, 4, 2, 64, 16, True, 0, None),       # the smoke llama's heads
    (1, 8, 2, 96, 32, True, 0, None),       # H / Hkv = 4
    (2, 4, 1, 80, 16, False, 0, None),      # MQA, not causal
    (1, 4, 2, 128, 16, True, 32, None),     # window
    (2, 4, 2, 64, 16, True, 0, 40),         # kv_len < S
    (1, 6, 3, 72, 24, False, 0, 50),        # kv_len, not causal
])
def test_gqa_and_kv_len_match_dot_attention(B, H, Hkv, S, D, causal, window,
                                            kv_len):
    """The model's layout [B, S, H, D] against the JAX model's GQA attention
    (kv_len as kv_valid), and against the JAX oracle with K/V repeated."""
    q, k, v = _qkv(1, B, H, Hkv, S, D)
    qs, ks, vs = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    pos = jnp.arange(S, dtype=jnp.int32)
    kv_valid = None
    if kv_len is not None:
        kv_valid = jnp.broadcast_to(pos < kv_len, (B, S))
    ref = np.asarray(jax_dot_attention(
        jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs), pos, pos,
        causal=causal, window=window, kv_valid=kv_valid))
    out = attention(*_t(qs, ks, vs), causal=causal, window=window,
                    kv_len=kv_len).numpy()
    assert np.abs(out - ref).max() < TOL
    if kv_len is None:
        G = H // Hkv
        rep = np.asarray(jax_attention_ref(
            jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, axis=1),
            jnp.repeat(jnp.asarray(v), G, axis=1), causal=causal,
            window=window))
        out_bhsd = flash_attention(*_t(q, k, v), causal=causal, window=window,
                                   device="cpu").numpy()
        assert np.abs(out_bhsd - rep).max() < TOL


@pytest.mark.parametrize("causal,kv_len", [(True, 200), (False, 130)])
def test_kv_len_matches_pallas_kernel(causal, kv_len):
    """kv_len (padded keys) against the Pallas kernel itself."""
    BH, S, D = 2, 256, 128
    q, k, v = _qkv(2, 1, BH, BH, S, D)
    ref = np.asarray(flash_attention_pallas(
        jnp.asarray(q[0]), jnp.asarray(k[0]), jnp.asarray(v[0]),
        causal=causal, kv_len=kv_len, interpret=True))
    out = flash_attention(*_t(q, k, v), causal=causal, kv_len=kv_len,
                          device="cpu").numpy()[0]
    assert np.abs(out - ref).max() < TOL


def test_bf16_plain_version_matches_oracle():
    q, k, v = _qkv(3, 1, 2, 2, 256, 128)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jax_attention_ref(jq, jk, jv).astype(jnp.float32))
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    out = flash_attention(tq, tk, tv, device="cpu")
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() < 3e-2


def test_cpu_calls_never_count_launches():
    before = flash_attention.launches
    q, k, v = _t(*_qkv(4, 1, 2, 1, 64, 16))
    flash_attention(q, k, v, device="cpu")
    attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert flash_attention.launches == before == 0


def test_kernel_binding_rejects_cpu_tensors():
    """The CUDA binding checks its inputs before it builds or launches."""
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, q, q, torch.empty_like(q), causal=True,
                            window=0, kv_len=8)


def test_tensors_off_the_asked_device_raise():
    q, k, v = _t(*_qkv(5, 1, 2, 2, 32, 16))
    with pytest.raises(ValueError, match="asked for"):
        flash_attention(q, k, v, device="meta")


# ---------------------------------------------------------------------------
# The choice of the kernel's body (pure Python; the launch needs the card)
# ---------------------------------------------------------------------------

_ALIGNED = [0x7F0000000000 + 512 * i for i in range(4)]


def _bshd_strides(B, S, H, Hkv, D):
    """Batch, seq and head strides of contiguous [B, S, heads, D] q, k, v,
    out."""
    qs = [S * H * D, H * D, D]
    ks = [S * Hkv * D, Hkv * D, D]
    return qs + ks + ks + qs


@pytest.mark.parametrize("dtype,D,strides,ptrs,want", [
    (torch.bfloat16, 64, _bshd_strides(8, 512, 32, 8, 64), _ALIGNED, "wgmma"),
    (torch.bfloat16, 128, _bshd_strides(2, 384, 8, 2, 128), _ALIGNED, "wgmma"),
    (torch.bfloat16, 8, _bshd_strides(1, 200, 2, 2, 8), _ALIGNED, "wgmma"),
    (torch.bfloat16, 100, _bshd_strides(2, 256, 8, 2, 100), _ALIGNED, "mma"),
    (torch.bfloat16, 36, _bshd_strides(1, 64, 2, 2, 36), _ALIGNED, "mma"),
    (torch.bfloat16, 64, [8 * 64 * 12, 64 * 12 + 4, 64] * 4, _ALIGNED, "mma"),
    (torch.bfloat16, 64, [0, 64, 64 * 64] * 4, _ALIGNED, "mma"),
    (torch.bfloat16, 64, _bshd_strides(1, 64, 2, 2, 64),
     _ALIGNED[:3] + [_ALIGNED[3] + 8], "mma"),
    (torch.float32, 64, _bshd_strides(8, 512, 32, 8, 64), _ALIGNED, "simt"),
    (torch.float32, 100, _bshd_strides(2, 256, 8, 2, 100), _ALIGNED, "simt"),
    # 128 < D <= 256: wgmma refuses, mma takes bf16 and simt f32
    (torch.bfloat16, 192, _bshd_strides(2, 256, 8, 2, 192), _ALIGNED, "mma"),
    (torch.bfloat16, 200, _bshd_strides(2, 256, 8, 2, 200), _ALIGNED, "mma"),
    (torch.bfloat16, 256, _bshd_strides(2, 1024, 16, 8, 256), _ALIGNED, "mma"),
    (torch.bfloat16, 256, _bshd_strides(2, 1024, 16, 1, 256), _ALIGNED, "mma"),
    (torch.float32, 192, _bshd_strides(2, 256, 8, 2, 192), _ALIGNED, "simt"),
    (torch.float32, 200, _bshd_strides(2, 256, 8, 2, 200), _ALIGNED, "simt"),
    (torch.float32, 256, _bshd_strides(2, 1024, 16, 8, 256), _ALIGNED, "simt"),
])
def test_auto_body_choice(dtype, D, strides, ptrs, want):
    from repro_torch.kernels.flash_attention.kernel import select_body, takes
    assert select_body(dtype, D, strides, ptrs) == want
    assert takes(want, dtype, D, strides, ptrs)
    # mma takes every bf16 call, simt every f32 call, and nothing else
    assert takes("mma", dtype, D, strides, ptrs) == (dtype == torch.bfloat16)
    assert takes("simt", dtype, D, strides, ptrs) == (dtype == torch.float32)
    # the wgmma body's register budget stops at D = 128
    if D > 128:
        assert not takes("wgmma", dtype, D, strides, ptrs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [0, 257, 512])
def test_head_dim_past_the_limit_raises(dtype, D):
    """No body takes D > 256 (nor D = 0), and the error names the limit."""
    from repro_torch.kernels.flash_attention.kernel import (BODIES, D_MAX,
                                                            select_body, takes)
    assert D_MAX == 256
    strides = _bshd_strides(1, 64, 2, 2, max(D, 1))
    assert not any(takes(b, dtype, D, strides, _ALIGNED) for b in BODIES)
    with pytest.raises(ValueError, match="D <= 256"):
        select_body(dtype, D, strides, _ALIGNED)


def test_model_layout_takes_wgmma():
    """The q, k, v the smoke model hands to ``attention`` in a prefill meet
    the wgmma body's rules (byte offsets from an aligned base)."""
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attention.kernel import select_body
    from repro_torch.models import transformer
    from repro_torch.models.zoo import build
    cfg = configs.get_smoke("llama3.2-1b").scaled(compute_dtype="float32")
    model = build(cfg, device="cpu")
    seen = []

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        return attention(q, k, v, **kw)

    saved = transformer.attention
    transformer.attention = spy
    try:
        tok = torch.zeros((2, 16), dtype=torch.int64)
        with torch.inference_mode():
            model.prefill({"tokens": tok}, model.init_cache(2, 16))
    finally:
        transformer.attention = saved
    assert len(seen) == cfg.n_layers
    for q, k, v in seen:
        out = torch.empty(q.shape)
        strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
        offsets = [2 * x.storage_offset() for x in (q, k, v, out)]
        assert select_body(torch.bfloat16, q.shape[-1], strides,
                           offsets) == "wgmma"


def test_unknown_body_raises():
    from repro_torch.kernels.flash_attention.kernel import takes
    q, k, v = _t(*_qkv(6, 1, 2, 2, 32, 16))
    with pytest.raises(ValueError, match="unknown body"):
        flash_attention(q, k, v, device="cpu", body="tma")
    with pytest.raises(ValueError, match="unknown body"):
        takes("wmma", torch.bfloat16, 64, [64] * 12, _ALIGNED)


@pytest.mark.parametrize("body", ["wgmma", "mma", "simt"])
def test_body_with_cpu_tensor_raises(body):
    """A body names a kernel; a CPU tensor only takes the plain version."""
    q, k, v = _t(*_qkv(7, 1, 2, 2, 32, 16))
    with pytest.raises(ValueError, match="CPU tensor"):
        flash_attention(q, k, v, device="cpu", body=body)
    with pytest.raises(ValueError, match="CPU tensor"):
        attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  body=body)
    assert flash_attention.launches == 0
    assert set(flash_attention.launches_by_body.values()) == {0}


@pytest.mark.parametrize("kv_len", [0, -1])
@pytest.mark.parametrize("causal", [True, False])
def test_kv_len_below_one_raises(kv_len, causal):
    """With no live key the reference averages V (every score -1e30), the
    Pallas kernel reads kv_len=0 as S, and the CUDA kernel wrote zeros:
    ``attention`` refuses kv_len < 1 on every route."""
    q, k, v = _t(*_qkv(8, 1, 2, 2, 32, 16))
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q, k, v, causal=causal, kv_len=kv_len, device="cpu")
    with pytest.raises(ValueError, match="kv_len"):
        attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal=causal, kv_len=kv_len)
