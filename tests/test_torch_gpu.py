"""Tests of the port that need the card: the flash-attention kernel (each
body, and its autograd Function against autograd through the plain
version; one training step of the smoke model), range-filter, dequant
(both bodies) and BP32-unpack kernels against their plain versions, the
choice of the flash-attention body, the smoke model on CUDA against the
CPU, windowed smoke models (D = 256 and 128), MLA, RG-LRU and whisper's
encoder-decoder (its encoder's non-causal launches) against the plain
route, predicate and quantized reads on CUDA against the CPU, and the
sharded training step and MoE on a (1, 1) NCCL mesh against the unsharded
model, the MoE's grouped path at mixtral-8x22b's width with no host
synchronisation, decode replayed from a CUDA graph against eager decode,
and the decode-attention kernel against the model's plain decode
attention. They skip where CUDA is absent. On an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import repro_torch.configs as configs
from repro_torch.core.quantization import (QuantMode, QuantSpec,
                                           affine_spec_for, dequantize)
from repro_torch.data import write_ads_table, write_quant_table
from repro_torch.dataset import dataset
from repro_torch.kernels.bitunpack import bitunpack, bitunpack_ref, pack_bp32
from repro_torch.kernels.dequant import (dequant, dequant_columns,
                                        dequant_packed, dequant_packed_ref,
                                        dequant_ref, pack_columns)
from repro_torch.kernels.dequant.staging import (CODE_TYPES, DESC_DTYPE,
                                                 TILE_BYTES)
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
    (8, 32, 8, 512, 64, True, 0, None),     # the training shape (simt)
    (1, 4, 1, 1000, 64, True, 0, None),     # ragged S, MQA
    (2, 4, 2, 40, 64, True, 0, None),       # S < 64: one partial tile
    (1, 2, 2, 150, 1, True, 0, None),       # D = 1
    (2, 4, 2, 130, 60, False, 0, None),     # D = 60, ragged
    (2, 8, 2, 300, 64, True, 48, None),     # window, H/Hkv = 4
    (1, 4, 4, 300, 128, False, 0, 200),     # D = 128, kv_len < S, 1:1
    (2, 4, 1, 333, 200, True, 100, None),   # D = 200, window, MQA
    (1, 4, 4, 300, 256, True, 0, 250),      # D = 256, kv_len < S
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_strided_model_layout(cuda, dtype):
    """[B, S, H, D] views of a fused projection, as the model may give."""
    rng = np.random.default_rng(1)
    B, S, H, Hkv, D = 2, 128, 4, 2, 64
    qkv = torch.tensor(rng.normal(size=(B, S, (H + 2 * Hkv) * D)),
                       dtype=dtype, device=cuda)
    q = qkv[..., :H * D].unflatten(-1, (H, D))
    k = qkv[..., H * D:(H + Hkv) * D].unflatten(-1, (Hkv, D))
    v = qkv[..., (H + Hkv) * D:].unflatten(-1, (Hkv, D))
    out = attention(q, k, v)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2)).transpose(1, 2)
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D", [
    (2, 8, 2, 200, 64),      # GQA 4:1, S not a multiple of the tile
    (1, 4, 4, 256, 64),      # 1:1
    (2, 8, 2, 130, 128),     # GQA 4:1, D = 128, ragged S
    (1, 4, 4, 300, 128),     # 1:1, D = 128, ragged S
])
def test_attention_function_grads_match_plain(cuda, dtype, B, H, Hkv, S, D):
    """The autograd Function (the kernel's forward, the plain backward)
    against autograd through attention_ref, on the model's layout, within
    TOL x max(1, the largest gradient); one launch, by the body "auto"
    takes (simt for f32, wgmma for bf16)."""
    rng = np.random.default_rng(3)
    shapes = [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)]
    inputs = [torch.tensor(rng.normal(size=sh), dtype=dtype, device=cuda)
              for sh in shapes]
    dout = torch.tensor(rng.normal(size=shapes[0]), dtype=dtype, device=cuda)
    got = [x.clone().requires_grad_(True) for x in inputs]
    ref = [x.clone().requires_grad_(True) for x in inputs]
    before = dict(flash_attention.launches_by_body)
    out = attention(*got, causal=True)
    ran = {b: n - before[b] for b, n in
           flash_attention.launches_by_body.items() if n != before[b]}
    assert ran == {"simt" if dtype == torch.float32 else "wgmma": 1}
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    out.backward(dout)
    attention_ref(*(x.transpose(1, 2) for x in ref),
                  causal=True).transpose(1, 2).backward(dout)
    # gradients exceed the outputs' magnitude: the tolerance scales with
    # the largest (bf16 rounds a gradient of 2-4 in steps of 1/64)
    for a, b in zip(got, ref):
        scale = max(1.0, b.grad.float().abs().max().item())
        err = (a.grad.float() - b.grad.float()).abs().max().item()
        assert err < TOL[dtype] * scale, (err, scale)


def test_smoke_train_step_on_cuda_matches_cpu(cuda):
    """One f32 step of the smoke model on the card from the CPU model's
    state: 2 launches a layer (the forward and its recompute), all simt,
    and the loss the CPU's."""
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    cfg = configs.get_smoke("llama3.2-1b").scaled(compute_dtype="float32")
    cpu_model = build(cfg, device="cpu")
    gpu_model = build(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    batch = {"tokens": np.random.default_rng(4).integers(
        0, cfg.vocab, (4, 65)).astype(np.int32)}
    losses = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, cuda)):
        before = dict(flash_attention.launches_by_body)
        step = make_train_step(model, AdamWConfig(), device=dev)
        losses.append(float(step(adamw_init(model), batch)["loss"]))
    ran = {b: n - before[b] for b, n in
           flash_attention.launches_by_body.items() if n != before[b]}
    assert ran == {"simt": 2 * cfg.n_layers}
    assert abs(losses[1] - losses[0]) < 1e-5 * abs(losses[0])


@pytest.mark.parametrize("arch,head_dim,body", [
    ("gemma3_12b", 256, "wgmma"),       # local:swiglu x 2 + global, D = 256
    ("mixtral_8x22b", 128, "wgmma"),    # window:moe, D = 128
])
def test_windowed_model_prefill_matches_plain(cuda, arch, head_dim, body):
    """A smoke-size model of a windowed family in bf16 with the prompt (160)
    past its window (64): every prefill attention launches the kernel,
    with the block's window, in the body the rule gives; the logits match
    the same model with the plain version of attention in its place
    (chip_smoke.py's bf16 bound, 2e-2 x max + 1e-3)."""
    from repro_torch.models import transformer
    cfg = configs.get_smoke(arch).scaled(head_dim=head_dim, window=64,
                                         capacity_factor=16.0)
    model = build(cfg, device=cuda, dtype=torch.bfloat16, seed=5)
    tok = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 160)), device=cuda)

    def prefill():
        return model.prefill({"tokens": tok}, model.init_cache(
            2, 192, dtype=torch.float32))[0]

    def plain(q, k, v, **kw):
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), **kw).transpose(1, 2)

    with torch.inference_mode():
        before = (dict(flash_attention.launches_by_body),
                  dict(flash_attention.launches_by_window))
        got = prefill()
        torch.cuda.synchronize()
        by_body = {b: n - before[0][b] for b, n in
                   flash_attention.launches_by_body.items() if n != before[0][b]}
        by_window = {w: n - before[1].get(w, 0) for w, n in
                     flash_attention.launches_by_window.items()
                     if n != before[1].get(w, 0)}
        saved = transformer.attention
        transformer.attention = plain
        try:
            want = prefill()
        finally:
            transformer.attention = saved
    windowed = sum(rep for blocks, rep in cfg.segments for b in blocks
                   if b.split(":")[0] in ("window", "local"))
    assert by_body == {body: cfg.n_layers}
    assert by_window == {64: windowed, **({0: cfg.n_layers - windowed}
                                          if windowed < cfg.n_layers else {})}
    assert bool(torch.isfinite(got).all())
    bound = 2e-2 * want.float().abs().max().item() + 1e-3
    assert (got.float() - want.float()).abs().max().item() < bound


@pytest.mark.parametrize("arch,attending", [("minicpm3_4b", 2),
                                             ("recurrentgemma_9b", 1)])
def test_new_family_prefill_matches_plain(cuda, arch, attending):
    """A smoke-size MLA or RG-LRU model in bf16: each layer that attends
    launches the kernel once in the wgmma body (MLA at its qk dim, V
    padded; recurrentgemma's local layer with its window, the prompt past
    it), the recurrent layers none; the logits match the same model with
    the plain version of attention in its place (chip_smoke.py's bf16
    bound, 2e-2 x max + 1e-3)."""
    from repro_torch.models import mla, transformer
    cfg = configs.get_smoke(arch)
    model = build(cfg, device=cuda, dtype=torch.bfloat16, seed=6)
    tok = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 40)), device=cuda)

    def prefill():
        return model.prefill({"tokens": tok}, model.init_cache(
            2, 48, dtype=torch.float32))[0]

    def plain(q, k, v, **kw):
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), **kw).transpose(1, 2)

    with torch.inference_mode():
        before = dict(flash_attention.launches_by_body)
        got = prefill()
        torch.cuda.synchronize()
        ran = {b: n - before[b] for b, n in
               flash_attention.launches_by_body.items() if n != before[b]}
        saved = transformer.attention
        transformer.attention = mla.attention = plain
        try:
            want = prefill()
        finally:
            transformer.attention = mla.attention = saved
    assert ran == {"wgmma": attending}
    assert bool(torch.isfinite(got).all())
    bound = 2e-2 * want.float().abs().max().item() + 1e-3
    assert (got.float() - want.float()).abs().max().item() < bound


def test_encdec_prefill_matches_plain(cuda):
    """whisper-base's smoke config over 1500 frames: each encoder layer
    launches the kernel not causal, each decoder layer causal, in the
    body the rule gives (wgmma at bf16, simt at f32). At f32 the logits
    match the same model with the plain version of attention in its place
    (tests/test_torch_families.py's bound). At bf16 each launch's output
    matches the plain version with f32 probabilities on that launch's own
    q, k, v, within chip_smoke.py's 2e-2 x max|ref| + 1e-3: rounding the
    probabilities alone moves a random-init whisper's bf16 logits past
    that bound (chip_smoke.py's logits_witness; PERF.md)."""
    from repro_torch.models import encdec
    from repro_torch.models.config import EncoderConfig
    rng = np.random.default_rng(7)
    tokens = torch.tensor(rng.integers(0, 256, (2, 40)), device=cuda)
    frames = torch.tensor(rng.normal(size=(2, 1500, 64)),
                          dtype=torch.float32, device=cuda)

    def plain(q, k, v, **kw):
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), **kw).transpose(1, 2)

    def plain32(q, k, v, **kw):
        return plain(q.float(), k.float(), v.float(), **kw)

    errs = []

    def held(q, k, v, **kw):
        out = attention(q, k, v, **kw)
        ref = plain32(q, k, v, **kw)
        errs.append(((out.float() - ref).abs().max().item(),
                     2e-2 * ref.abs().max().item() + 1e-3))
        return out

    for dtype, body in ((torch.bfloat16, "wgmma"), (torch.float32, "simt")):
        cfg = configs.get_smoke("whisper_base").scaled(
            compute_dtype=str(dtype).replace("torch.", ""),
            encoder=EncoderConfig(n_layers=2, seq=1500, d_input=64))
        model = build(cfg, device=cuda, dtype=dtype, seed=7)

        def prefill(attn):
            saved = encdec.attention
            encdec.attention = attn
            try:
                return model.prefill({"tokens": tokens, "frames": frames},
                                     model.init_cache(2, 48,
                                                      dtype=torch.float32))[0]
            finally:
                encdec.attention = saved

        with torch.inference_mode():
            before = (dict(flash_attention.launches_by_body),
                      dict(flash_attention.launches_by_causal))
            errs.clear()
            got = prefill(held)
            torch.cuda.synchronize()
            by_body = {b: n - before[0][b] for b, n in
                       flash_attention.launches_by_body.items()
                       if n != before[0][b]}
            by_causal = {c: n - before[1].get(c, 0) for c, n in
                         flash_attention.launches_by_causal.items()
                         if n != before[1].get(c, 0)}
            want = prefill(plain)
        assert by_body == {body: 4} and by_causal == {False: 2, True: 2}
        assert bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            bound = 1e-4 * want.abs().max().item() + 1e-5
            assert (got - want).abs().max().item() < bound
        else:
            assert len(errs) == 4 and all(e < b for e, b in errs), errs


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


def _same_bits(a, b):
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arith", [torch.float32, torch.float64])
@pytest.mark.parametrize("code", [np.int8, np.uint8, np.int16, np.uint16])
@pytest.mark.parametrize("shape", [(130, 70), (65539, 1), "transposed"])
def test_dequant_bit_identical(cuda, code, arith, out_dtype, shape):
    rng = np.random.default_rng(11)
    info = np.iinfo(code)
    if shape == "transposed":
        full = rng.integers(info.min, info.max + 1, (260, 600)).astype(code)
        q = torch.from_numpy(full).to(cuda).t()[::3, 4:]
    else:
        q = torch.from_numpy(rng.integers(info.min, info.max + 1, shape)
                             .astype(code)).to(cuda)
    C_ = q.shape[1]
    s = torch.from_numpy(rng.uniform(1e-3, 1.0, C_)).to(cuda, arith)
    z = torch.from_numpy(rng.normal(size=C_)).to(cuda, arith)
    before = dequant.launches
    got = dequant(q, s, z, out_dtype)
    torch.cuda.synchronize()
    assert dequant.launches == before + 1
    assert _same_bits(got, dequant_ref(q, s, z, out_dtype))
    assert _same_bits(got.cpu(), dequant_ref(q.cpu(), s.cpu(), z.cpu(),
                                             out_dtype))


@pytest.mark.parametrize("mode,code", [(QuantMode.INT8_AFFINE, np.int8),
                                       (QuantMode.UINT8_AFFINE, np.uint8),
                                       (QuantMode.INT16_AFFINE, np.int16),
                                       (QuantMode.BF16, np.uint16)])
def test_dequant_f64_every_code_equals_dequantize(cuda, mode, code):
    x = np.random.default_rng(12).normal(size=10_000)
    spec = QuantSpec(mode) if mode == QuantMode.BF16 \
        else affine_spec_for(x, mode)
    info = np.iinfo(code)
    codes = np.arange(info.min, info.max + 1).astype(code)
    params = torch.tensor([spec.scale, spec.zero], dtype=torch.float64,
                          device=cuda)
    got = dequant(torch.from_numpy(codes).to(cuda).view(-1, 1), params[:1],
                  params[1:], torch.float32)
    want = dequantize(codes, spec)
    assert np.array_equal(got.cpu().numpy().reshape(-1).view(np.uint32),
                          want.view(np.uint32))


@pytest.mark.parametrize("width", [1, 7, 11, 16, 31, 32])
@pytest.mark.parametrize("n", [1, 31, 8192 + 7 * 32, 100_003])
def test_bitunpack_exact(cuda, width, n):
    rng = np.random.default_rng(width * 7 + n)
    vals = rng.integers(0, 2**width, n, dtype=np.uint64).astype(np.uint32)
    planes = pack_bp32(vals, width)
    before = bitunpack.launches
    got = bitunpack(planes, width, n)
    torch.cuda.synchronize()
    assert bitunpack.launches == before + 1
    assert np.array_equal(got.cpu().numpy(), vals)
    pd = torch.from_numpy(planes).to(cuda)
    assert torch.equal(got.view(torch.int32),
                       bitunpack_ref(pd, width)[:n].view(torch.int32))


def test_bitunpack_strided_planes(cuda):
    rng = np.random.default_rng(13)
    big = rng.integers(0, 2**32, (4096, 32), dtype=np.uint64).astype(np.uint32)
    view = torch.from_numpy(big).to(cuda)[:, :12]
    got = bitunpack(view, 12, 4096 * 32 - 5)
    want = bitunpack_ref(view.cpu(), 12)[:4096 * 32 - 5]
    assert np.array_equal(got.cpu().numpy(), want.numpy())


MODES = {np.int8: QuantMode.INT8_AFFINE, np.uint8: QuantMode.UINT8_AFFINE,
         np.int16: QuantMode.INT16_AFFINE, np.uint16: QuantMode.BF16}


def _column_group(seed, n_cols, max_rows):
    """All four code types at odd lengths, column 2 empty, with specs."""
    rng = np.random.default_rng(seed)
    codes, specs = [], []
    for i in range(n_cols):
        code = list(MODES)[i % 4]
        rows = 0 if i == 2 else int(rng.integers(1, max_rows)) | 1
        info = np.iinfo(code)
        codes.append(rng.integers(info.min, info.max + 1, rows).astype(code))
        specs.append(QuantSpec(QuantMode.BF16) if code == np.uint16 else
                     affine_spec_for(rng.normal(size=100) * (i + 1), MODES[code]))
    return codes, specs


def _f32_bits(t):
    return np.asarray(t.cpu().numpy() if isinstance(t, torch.Tensor) else t) \
        .view(np.uint32)


@pytest.mark.parametrize("n_cols,max_rows", [(1, 2**20), (7, 100_000),
                                             (70, 5000)])
def test_dequant_columns_bit_identical(cuda, n_cols, max_rows):
    """The column-list body against its plain version on the card and
    NumPy ``dequantize``, one launch for the whole list."""
    codes, specs = _column_group(n_cols, n_cols, max_rows)
    params = [(sp.scale, sp.zero) for sp in specs]
    before = dequant_packed.launches
    got = dequant_columns(codes, params)
    assert dequant_packed.launches == before + 1
    packed = pack_columns(codes, params)
    staging = packed.buffer.to(cuda)
    plain = dequant_packed_ref(staging, packed.n_cols, packed.n_out)
    on_card = dequant_packed(staging, packed.n_cols, packed.n_tiles,
                             packed.n_out)
    torch.cuda.synchronize()
    for q, spec, g, at in zip(codes, specs, got, packed.out_offsets):
        assert g.device.type == "cpu" and g.dtype == torch.float32
        want = _f32_bits(dequantize(q, spec))
        assert np.array_equal(_f32_bits(g), want)
        assert np.array_equal(_f32_bits(plain[at:at + len(q)]), want)
        assert np.array_equal(_f32_bits(on_card[at:at + len(q)]), want)


def test_dequant_packed_unaligned_columns(cuda):
    """Columns laid out by hand at offsets the packer never chooses (codes
    aligned only to their size, outputs back to back): the scalar path."""
    rng = np.random.default_rng(14)
    codes = [rng.integers(-128, 128, 37).astype(np.int8),
             rng.integers(0, 2**16, 100_001).astype(np.uint16),
             rng.integers(0, 256, 9000).astype(np.uint8),
             rng.integers(-2**15, 2**15, 20_017).astype(np.int16)]
    params = [(0.25, -3.0), (0.0, 0.0), (0.01, 5.0), (1e-3, 0.5)]
    head = len(codes) * DESC_DTYPE.itemsize
    code_offsets, pos = [], head + 1
    for q in codes:
        pos = -(-pos // q.itemsize) * q.itemsize + q.itemsize * 3
        code_offsets.append(pos)
        pos += q.nbytes
    out_offsets = list(np.cumsum([3] + [len(q) for q in codes[:-1]]))
    desc = np.zeros(len(codes), DESC_DTYPE)
    tile = 0
    for d, q, (sc, ze), off, at in zip(desc, codes, params, code_offsets,
                                       out_offsets):
        d["code_offset"], d["out_offset"], d["rows"] = off, at, len(q)
        d["tile_start"], d["scale"], d["zero"] = tile, sc, ze
        d["q_type"] = CODE_TYPES[q.dtype]
        tile += -(-q.nbytes // TILE_BYTES)
    host = np.zeros(pos, np.uint8)
    host[:head] = desc.view(np.uint8)
    for q, off in zip(codes, code_offsets):
        host[off:off + q.nbytes].view(q.dtype)[:] = q
    staging = torch.from_numpy(host).to(cuda)
    n_out = out_offsets[-1] + len(codes[-1])
    got = dequant_packed(staging, len(codes), tile, n_out)
    plain = dequant_packed_ref(staging, len(codes), n_out)
    torch.cuda.synchronize()
    for q, (sc, ze), at in zip(codes, params, out_offsets):
        spec = QuantSpec(QuantMode.BF16) if q.dtype == np.uint16 \
            else QuantSpec(MODES[q.dtype.type], sc, ze)
        want = _f32_bits(dequantize(q, spec))
        assert np.array_equal(_f32_bits(got[at:at + len(q)]), want)
        assert np.array_equal(_f32_bits(plain[at:at + len(q)]), want)


def test_dequant_columns_outlive_the_next_call(cuda):
    """The columns handed back are views of page-locked memory that no
    later call reuses while they live."""
    codes, specs = _column_group(15, 8, 50_000)
    params = [(sp.scale, sp.zero) for sp in specs]
    first = dequant_columns(codes, params)
    kept = [_f32_bits(c).copy() for c in first]
    for _ in range(3):
        dequant_columns([c[::-1].copy() for c in codes], params)
    assert all(np.array_equal(_f32_bits(a), b) for a, b in zip(first, kept))


@pytest.mark.parametrize("width", range(1, 33))
def test_bitunpack_every_width_ragged(cuda, width):
    """The bit transpose at every width, at a ragged length, on contiguous
    and on strided planes, against the values packed and the plain
    version."""
    rng = np.random.default_rng(100 + width)
    n = 32 * 1000 + width * 7 + 3
    vals = rng.integers(0, 2**width, n, dtype=np.uint64).astype(np.uint32)
    planes = pack_bp32(vals, width)
    before = bitunpack.launches
    got = bitunpack(planes, width, n)
    torch.cuda.synchronize()
    assert bitunpack.launches == before + 1
    assert np.array_equal(got.cpu().numpy(), vals)
    wide = np.zeros((planes.shape[0], 33), np.uint32)
    wide[:, 1:width + 1] = planes
    view = torch.from_numpy(wide).to(cuda)[:, 1:width + 1]
    got = bitunpack(view, width, n)
    assert np.array_equal(got.cpu().numpy(), vals)
    assert torch.equal(got.view(torch.int32),
                       bitunpack_ref(view, width)[:n].view(torch.int32))


def test_quantized_read_on_cuda_matches_cpu(cuda, tmp_path):
    path = str(tmp_path / "quant.bln")
    write_quant_table(path, n_rows=8192, rows_per_group=2048)
    cols = ["id", "q_i8", "q_u8", "q_i16", "q_bf16", "q_fp8", "q_fp16"]
    pred = (C("q_i8") > -0.5) & (C("q_i16") <= 2.0)
    ds = dataset(path, device="cuda").select(cols).where(pred)
    before = (dequant.launches, dequant_packed.launches)
    got = ds.to_table(parallelism=2)
    # one column-list launch for the predicate's columns and one for the
    # payload's, in each row group
    assert (dequant.launches, dequant_packed.launches) == (
        before[0], before[1] + 2 * len(ds.physical_plan().tasks))
    want = dataset(path, device="cpu").select(cols).where(pred) \
        ._with_kernel(False).to_table()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k].view(np.uint8), want[k].view(np.uint8))


# ---------------------------------------------------------------------------
# The flash-attention kernel's wgmma body, and the choice of body
# ---------------------------------------------------------------------------


def _bshd(rng, B, S, H, Hkv, D, layout, device, dtype=torch.bfloat16):
    """q, k, v as [B, S, heads, D] views: contiguous ("bshd"), transposed
    [B, heads, S, D] storage ("bhsd"), slices of one fused projection
    ("fused", as a model may give), or views one element past an aligned
    base with an odd head stride ("offset": no 16-byte copies)."""
    def mk(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=dtype,
                            device=device)
    if layout == "offset":
        return tuple(mk(B, S, n, D + 1)[..., 1:] for n in (H, Hkv, Hkv))
    if layout == "fused":
        qkv = mk(B, S, (H + 2 * Hkv) * D)
        return (qkv[..., :H * D].unflatten(-1, (H, D)),
                qkv[..., H * D:(H + Hkv) * D].unflatten(-1, (Hkv, D)),
                qkv[..., (H + Hkv) * D:].unflatten(-1, (Hkv, D)))
    if layout == "bhsd":
        return (mk(B, H, S, D).transpose(1, 2), mk(B, Hkv, S, D).transpose(1, 2),
                mk(B, Hkv, S, D).transpose(1, 2))
    return mk(B, S, H, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,kv_len,layout", [
    (8, 32, 8, 512, 64, True, 0, None, "bshd"),      # the serving shape
    (2, 8, 2, 384, 128, True, 0, None, "bshd"),      # D = 128, GQA 4:1
    (1, 4, 1, 200, 64, True, 0, None, "bshd"),       # ragged S
    (1, 4, 1, 200, 128, True, 0, None, "bhsd"),
    (2, 4, 4, 129, 64, True, 0, None, "bshd"),       # one row past a tile
    (2, 4, 4, 129, 128, False, 0, None, "bshd"),
    (2, 4, 1, 256, 64, False, 0, 130, "bshd"),       # kv_len
    (2, 4, 2, 256, 64, True, 0, 77, "bhsd"),
    (2, 4, 4, 256, 64, True, 64, None, "bshd"),      # window
    (1, 4, 2, 300, 128, True, 100, 250, "bshd"),
    (2, 4, 4, 256, 64, True, 0, None, "bhsd"),       # H = Hkv = 4
    (2, 1, 1, 256, 64, True, 0, None, "bshd"),       # H = Hkv = 1
    (2, 4, 4, 256, 32, False, 0, None, "bshd"),      # D = 32
    (2, 4, 2, 128, 64, True, 0, None, "fused"),      # the model's views
    (1, 8, 2, 96, 96, True, 0, None, "fused"),
    (2, 16, 8, 512, 256, True, 0, None, "fused"),    # gemma3-12b's prefill
    (2, 16, 8, 640, 256, True, 256, None, "fused"),  # its local layers
    (1, 4, 1, 200, 256, True, 0, 150, "bhsd"),       # D = 256, kv_len, MQA
    (2, 4, 4, 129, 192, False, 0, None, "bshd"),     # D = 192
    (8, 40, 40, 512, 96, True, 0, None, "bshd"),     # minicpm3-4b's MLA
    (16, 8, 8, 1500, 64, False, 0, None, "bshd"),    # whisper's encoder
    (2, 8, 8, 1500, 64, False, 0, None, "fused"),
    (2, 8, 8, 72, 64, True, 0, None, "bshd"),        # whisper's decoder
])
def test_wgmma_body_matches_plain(cuda, B, H, Hkv, S, D, causal, window,
                                  kv_len, layout):
    q, k, v = _bshd(np.random.default_rng(S + D), B, S, H, Hkv, D, layout,
                    cuda)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    before = dict(flash_attention.launches_by_body)
    out = attention(q, k, v, body="wgmma", **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_body["wgmma"] == before["wgmma"] + 1
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), **kw).transpose(1, 2)
    err = (out.float() - ref.float()).abs().max().item()
    assert err < _wgmma_bound(ref, S, causal)


def _wgmma_bound(ref, S, causal) -> float:
    """TOL[bf16]; not causal over S = 1500 keys (whisper's encoder), where
    a typical |out| is near TOL[bf16] itself, 2e-2 x max|ref| + 1e-3 as
    chip_smoke.py holds WHISPER_ENC."""
    if not causal and S == 1500:
        return 2e-2 * ref.float().abs().max().item() + 1e-3
    return TOL[torch.bfloat16]


@pytest.mark.parametrize("layout", ["bshd", "fused"])
def test_whisper_bound_sees_dropped_keys(cuda, layout):
    """The bound of the encoder's cases catches a kernel that skips the
    last 28 of its 1500 keys: the body with those keys masked off
    (kv_len), held against the full reference, is off by more."""
    q, k, v = _bshd(np.random.default_rng(1564), 2, 1500, 8, 8, 64, layout,
                    cuda)
    out = attention(q, k, v, body="wgmma", causal=False, kv_len=1472)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=False).transpose(1, 2)
    err = (out.float() - ref.float()).abs().max().item()
    assert err >= _wgmma_bound(ref, 1500, False)


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 100, "mma"), (torch.float32, 64, "simt"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 196, "mma"),
    (torch.bfloat16, 320, "mma"), (torch.float32, 512, "simt"),
])
def test_auto_takes_the_body_the_rule_gives(cuda, dtype, D, want):
    rng = np.random.default_rng(D)
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=dtype, device=cuda)
               for s in [(2, 128, 8, D), (2, 128, 2, D), (2, 128, 2, D)])
    before = dict(flash_attention.launches_by_body)
    n = flash_attention.launches
    out = attention(q, k, v)
    torch.cuda.synchronize()
    ran = {b: c - before[b] for b, c in flash_attention.launches_by_body.items()}
    assert ran == {b: int(b == want) for b in ran}
    assert flash_attention.launches == n + 1
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2)).transpose(1, 2)
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "mma"),
                                        (torch.float32, "simt"),
                                        (torch.bfloat16, "wgmma")])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,kv_len,layout", [
    (2, 16, 8, 256, 256, True, 0, None, "bshd"),     # gemma3-12b's heads
    (1, 4, 1, 200, 256, True, 0, None, "bhsd"),      # MQA, ragged S
    (2, 4, 2, 256, 256, True, 64, None, "bshd"),     # window
    (2, 4, 4, 192, 256, False, 0, 130, "bshd"),      # kv_len < S
    (1, 4, 2, 130, 200, True, 0, None, "bshd"),      # D = 200
    (1, 4, 2, 96, 192, False, 0, None, "fused"),
    (2, 4, 1, 300, 256, True, 100, 270, "fused"),    # window, kv_len, MQA
    (1, 8, 2, 40, 200, True, 0, None, "bhsd"),       # S < 64, GQA 4:1
])
def test_wide_heads_match_plain(cuda, dtype, body, B, H, Hkv, S, D, causal,
                                window, kv_len, layout):
    """128 < D <= 256 through the wgmma and mma (bf16) and simt (f32)
    bodies, and "auto" takes wgmma (bf16; every case is aligned, D % 8 ==
    0) or simt (f32). The inputs are made in their dtype, so the strided
    layouts reach the f32 body as views."""
    q, k, v = _bshd(np.random.default_rng(S + D), B, S, H, Hkv, D, layout,
                    cuda, dtype)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), **kw).transpose(1, 2)
    auto = "wgmma" if dtype == torch.bfloat16 else "simt"
    for asked in (body, "auto"):
        before = dict(flash_attention.launches_by_body)
        out = attention(q, k, v, body=asked, **kw)
        torch.cuda.synchronize()
        ran = {b: c - before[b]
               for b, c in flash_attention.launches_by_body.items()}
        want = auto if asked == "auto" else body
        assert ran == {b: int(b == want) for b in ran}
        assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype,want", [(torch.float32, "simt"),
                                        (torch.bfloat16, "mma")])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,kv_len", [
    (2, 8, 2, 256, 64, True, 0, None),
    (1, 4, 1, 1000, 64, True, 0, None),      # ragged S, MQA
    (2, 4, 4, 300, 100, True, 64, None),     # D = 100, window
    (1, 4, 2, 200, 128, False, 0, 150),      # kv_len < S
    (1, 4, 4, 130, 256, True, 0, None),      # D = 256
])
def test_unaligned_view_matches_plain(cuda, dtype, want, B, H, Hkv, S, D,
                                      causal, window, kv_len):
    """Views one element past an aligned base with an odd head stride: the
    simt body's 4-byte copies (f32) and the mma body's element loads
    (bf16), which "auto" takes."""
    q, k, v = _bshd(np.random.default_rng(S + D), B, S, H, Hkv, D, "offset",
                    cuda, dtype)
    assert q.data_ptr() % 16 != 0 and q.stride(2) % 4 != 0
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    before = dict(flash_attention.launches_by_body)
    out = attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ran = {b: c - before[b] for b, c in flash_attention.launches_by_body.items()}
    assert ran == {b: int(b == want) for b in ran}
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), **kw).transpose(1, 2)
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


def test_a_body_that_cannot_take_the_call_raises(cuda):
    q = torch.zeros(1, 64, 2, 100, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        attention(q, q, q, body="wgmma")             # D % 8 != 0
    with pytest.raises(ValueError, match="does not take"):
        attention(q.float(), q.float(), q.float(), body="mma")
    with pytest.raises(ValueError, match="does not take"):
        attention(q, q, q, body="simt")
    wide = torch.zeros(1, 64, 2, 196, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        attention(wide, wide, wide, body="wgmma")     # D % 8 != 0, D > 128
    unaligned = torch.zeros(1, 64, 2, 264, dtype=torch.bfloat16,
                            device=cuda)[..., 4:260]  # D = 256, 8-byte base
    with pytest.raises(ValueError, match="does not take"):
        attention(unaligned, unaligned, unaligned, body="wgmma")
    past = torch.zeros(1, 64, 2, 264, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        attention(past, past, past, body="wgmma")     # D > 256
    empty = torch.zeros(1, 64, 2, 0, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="D > 0"):
        attention(empty, empty, empty)


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "mma"),
                                        (torch.float32, "simt")])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,kv_len,layout", [
    (1, 4, 2, 200, 320, True, 0, None, "bshd"),      # two slices of D
    (2, 4, 1, 130, 512, True, 64, None, "bhsd"),     # window, MQA
    (1, 2, 2, 96, 300, False, 0, 70, "bshd"),        # kv_len, D % 8 != 0
    (1, 6, 2, 64, 264, True, 0, None, "fused"),      # a slice of 8 columns
])
def test_head_dims_past_256_match_plain(cuda, dtype, body, B, H, Hkv, S, D,
                                        causal, window, kv_len, layout):
    """D > 256 through mma (bf16) and simt (f32): a block a slice of 256
    output columns, scoring over the whole of D; "auto" takes the same."""
    q, k, v = _bshd(np.random.default_rng(S + D), B, S, H, Hkv, D, layout,
                    cuda, dtype)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), **kw).transpose(1, 2)
    for asked in (body, "auto"):
        before = dict(flash_attention.launches_by_body)
        out = attention(q, k, v, body=asked, **kw)
        torch.cuda.synchronize()
        ran = {b: c - before[b]
               for b, c in flash_attention.launches_by_body.items()}
        assert ran == {b: int(b == body) for b in ran}
        assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A (1, 1) ("data", "model") mesh over an NCCL group of one rank."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_test_mesh
    torch.cuda.set_device(0)
    tdist.init_process_group("nccl", rank=0, world_size=1,
                             store=tdist.FileStore(str(tmp_path / "s"), 1))
    try:
        yield make_test_mesh(1, 1)
    finally:
        tdist.destroy_process_group()


def test_sharded_train_step_on_one_card(nccl_mesh):
    """The sharded step (DTensor parameters, the flash kernel on local
    shards under local_map) on the card: 2 simt launches a layer, and the
    loss and every parameter within 2e-4 of the unsharded step's."""
    from repro_torch.distributed import make_dist
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    cfg = configs.get_smoke("llama3_2_1b").scaled(compute_dtype="float32")
    tokens = torch.randint(0, cfg.vocab, (4, 33),
                           generator=torch.Generator().manual_seed(1))
    out = []
    for dist in (None, make_dist(nccl_mesh)):
        m = build(cfg, device="cuda", dist=dist)
        step = make_train_step(m, AdamWConfig(lr=1e-3))
        before = dict(flash_attention.launches_by_body)
        loss = float(step(adamw_init(m), {"tokens": tokens})["loss"])
        torch.cuda.synchronize()
        ran = {b: n - before[b]
               for b, n in flash_attention.launches_by_body.items()}
        assert ran == dict(simt=2 * cfg.n_layers, mma=0, wgmma=0)
        out.append((loss, {k: p.full_tensor() if dist else p.detach()
                           for k, p in m.named_parameters()}))
    (l0, p0), (l1, p1) = out
    assert abs(l0 - l1) < 2e-4
    assert max((p0[k] - p1[k]).abs().max().item() for k in p0) < 2e-4


def test_sharded_moe_on_one_card(nccl_mesh):
    """deepseek-moe-16b's smoke model, capacity for every pair: the sharded
    MoE path's loss within 2e-3 of the local path's, its attention through
    the kernel (one launch a layer)."""
    from repro_torch.distributed import make_dist
    from repro_torch.models.moe import sharded_route
    cfg = configs.get_smoke("deepseek_moe_16b").scaled(
        compute_dtype="float32", capacity_factor=64.0)
    tokens = torch.randint(0, cfg.vocab, (4, 17),
                           generator=torch.Generator().manual_seed(1))
    losses = []
    for dist in (None, make_dist(nccl_mesh)):
        m = build(cfg, device="cuda", dist=dist)
        before = flash_attention.launches
        with torch.no_grad():
            losses.append(float(m.loss({"tokens": tokens})))
        assert flash_attention.launches == before + cfg.n_layers
    assert sharded_route(m.segments[1].b0[0].moe, m.dist)
    assert abs(losses[0] - losses[1]) < 2e-3


@pytest.mark.parametrize("T", [32, 4096])        # a decode step, a prefill
def test_grouped_moe_at_mixtral_width_syncs_nowhere(cuda, T, monkeypatch):
    """One mixtral-8x22b MoE layer at full width (8 experts of 16384, top 2,
    two chunks an expert) in bf16 at capacity factor E / k: the grouped
    path runs with synchronisation made an error, and its output equals
    the capacity path's to bf16's rounding."""
    from repro_torch.models import moe
    from repro_torch.models.base import init_tree
    cfg = configs.get("mixtral_8x22b").scaled(capacity_factor=4.0)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    p = dict(init_tree(moe.moe_decl(cfg), gen, cuda, torch.bfloat16).items())
    x = torch.randn(1, T, cfg.d_model, device=cuda, dtype=torch.bfloat16,
                    generator=gen)
    assert moe.dropless(cfg)
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, _ = moe.moe_apply(p, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        monkeypatch.setattr(moe, "dropless", lambda cfg: False)
        want, _ = moe.moe_apply(p, x, cfg)
    gap = (y.float() - want.float()).abs().max()
    assert gap <= TOL[torch.bfloat16] * want.float().abs().max()


# ---------------------------------------------------------------------------
# Decode replayed from a CUDA graph
# ---------------------------------------------------------------------------

# bf16 smoke models that take the graph: the MoE capacity path, the
# dropless grouped path (capacity factor E / k, two chunks an expert), and
# local and global layers decoded past their window of 8
GRAPH_CASES = {
    "moe_capacity": ("deepseek_moe_16b", {}),
    "moe_grouped": ("mixtral_8x22b", {"n_experts": 8, "capacity_factor": 4.0}),
    "window": ("gemma3_12b", {}),
}


def _graph_model(cuda, case, dtype="bfloat16"):
    arch, scaled = GRAPH_CASES[case]
    cfg = configs.get_smoke(arch).scaled(compute_dtype=dtype, **scaled)
    return build(cfg, device=cuda, dtype=getattr(torch, dtype))


def _eager_generate(model, prompts, n, max_seq):
    """``ServeEngine``'s greedy loop through ``decode_step``, eager, on a
    new cache: (tokens [B, n], the last step's logits)."""
    with torch.inference_mode():
        cache = model.init_cache(len(prompts), max_seq, dtype=torch.float32)
        logits, cache = model.prefill({"tokens": torch.as_tensor(
            prompts.astype(np.int64), device=model.device)}, cache)
        tok, out = logits.argmax(-1)[:, None], []
        for _ in range(n):
            out.append(tok)
            logits, cache = model.decode_step(cache, tok)
            tok = logits.argmax(-1)[:, None]
    return torch.cat(out, dim=1).cpu().numpy(), logits


def _decode_counts():
    from repro_torch.obs import metrics
    return tuple(metrics.counter(f"bullion.serve.decode_{n}").value
                 for n in ("graph_captures", "graph_replays", "eager_steps"))


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graph_replay_equals_eager_decode(cuda, case):
    """Two ``generate`` calls on one engine (the first captures, the second
    replays whole; other prompts, shorter) equal the eager decode bit for
    bit: the tokens and the last step's logits."""
    from repro_torch.serve import ServeEngine
    model = _graph_model(cuda, case)
    rng = np.random.default_rng(11)
    engine = ServeEngine(model, max_seq=32, device=cuda)
    for P, n in ((12, 14), (5, 16)):
        prompts = rng.integers(0, model.cfg.vocab, (4, P)).astype(np.int32)
        tokens = engine.generate(prompts, n)["tokens"]
        want, logits = _eager_generate(model, prompts, n, 32)
        kept = engine._kept
        assert kept.graph is not None
        assert np.array_equal(tokens, want), (P, n)
        assert torch.equal(kept.logits, logits), (P, n)


def test_graph_counters_and_a_second_batch_size(cuda):
    """A second batch size captures a second graph, in place of the first,
    and the first size, come back, a third. The counters: three captures,
    every step but each capture's warm-up replayed, none eager; a dropless
    MoE computing in float32 (whose grouped path synchronises) decodes
    eagerly, its steps counted as such."""
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.lm import WARMUP_STEPS
    model = _graph_model(cuda, "moe_capacity")
    engine = ServeEngine(model, max_seq=24, device=cuda)
    rng = np.random.default_rng(12)
    before = _decode_counts()
    graphs = []
    for B, n in ((4, 6), (4, 6), (2, 7), (4, 5)):
        prompts = rng.integers(0, model.cfg.vocab, (B, 8)).astype(np.int32)
        engine.generate(prompts, n)
        assert engine._kept.B == B
        graphs.append(engine._kept.graph)
    after = _decode_counts()
    assert graphs[0] is graphs[1] and len({id(g) for g in graphs}) == 3
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) \
        == (3, 6 + 6 + 7 + 5 - 3 * WARMUP_STEPS, 0)
    f32 = _graph_model(cuda, "moe_grouped", dtype="float32")
    engine = ServeEngine(f32, max_seq=24, device=cuda)
    engine.generate(rng.integers(0, f32.cfg.vocab, (2, 8)).astype(np.int32),
                    5)
    assert _decode_counts() == (after[0], after[1], after[2] + 5)


def test_replays_count_the_captured_steps_counters(cuda):
    """The MoE's grouped-path counters count a replayed step as they count
    an eager one: a call of n new tokens adds a call a MoE layer for the
    prefill and for each step, whether it captures or replays whole."""
    from repro_torch.obs import metrics
    from repro_torch.serve import ServeEngine
    model = _graph_model(cuda, "moe_grouped")
    layers = sum(n * sum(b.endswith(":moe") for b in blocks)
                 for blocks, n in model.cfg.segments)
    engine = ServeEngine(model, max_seq=32, device=cuda)
    rng = np.random.default_rng(13)
    for P, n in ((12, 9), (6, 11)):
        calls = metrics.counter("bullion.moe.grouped_calls").value
        pairs = metrics.counter("bullion.moe.grouped_pairs").value
        prompts = rng.integers(0, model.cfg.vocab, (4, P)).astype(np.int32)
        engine.generate(prompts, n)
        assert engine._kept.graph is not None
        assert metrics.counter("bullion.moe.grouped_calls").value - calls \
            == layers * (1 + n)
        assert metrics.counter("bullion.moe.grouped_pairs").value - pairs \
            == layers * model.cfg.top_k * 4 * (P + n)


def test_device_span_during_capture_records_no_device_time(cuda):
    """A device span opened while a CUDA graph is captured records no CUDA
    event (which would break the capture) and no ``device_s``; the graph
    replays what it holds."""
    from repro_torch.obs import trace
    x = torch.ones(1024, device=cuda)
    y = x * 2
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with trace.collect() as tr:
        with torch.cuda.graph(g):
            with trace.device_span("moe.experts", "model", path="grouped"):
                y = x * 2
    (rec,) = tr.spans
    assert rec.args == {"path": "grouped"}
    x.fill_(3.0)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(x, 6.0))


def test_decode_span_holds_its_device_ops_on_the_profilers_clock(cuda):
    """The tracer's spans and the profiler's device ops share one clock:
    in a small ``generate``, whose steps replay the decode step captured
    by the call before, every device op launched inside the
    ``serve.decode`` span (matched to its launch, a ``cudaGraphLaunch`` or
    ``cudaLaunchKernel``, by the runtime's correlation ids) starts after
    the span does and ends before it ends, since the span closes after a
    synchronise; and no device op straddles the span's end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import trace
    from repro_torch.serve import ServeEngine
    cfg = configs.get_smoke("deepseek_moe_16b").scaled(
        compute_dtype="bfloat16")
    engine = ServeEngine(build(cfg, device=cuda), max_seq=48, device=cuda)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (4, 16)) \
        .astype(np.int32)
    steps = 8
    engine.generate(prompts, steps)
    with trace.collect() as tr, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts, steps)
    (dec,) = [s for s in tr.spans if s.name == "serve.decode"]
    assert dec.args["graph_steps"] == steps
    a = trace.profiler_us(dec)
    b = a + dec.dur * 1e6
    events = list(prof.profiler.kineto_results.events())
    device = [e for e in events if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()]
    launches = {e.correlation_id(): e for e in events
                if e.device_type() == DeviceType.CPU
                and e.name() in ("cudaGraphLaunch", "cudaLaunchKernel")}
    launched = [e for e in device
                if e.correlation_id() in launches
                and a <= launches[e.correlation_id()].start_ns() / 1e3 <= b]
    assert len(launched) >= steps * cfg.n_layers, (len(launched), len(device))
    assert a <= min(e.start_ns() for e in launched) / 1e3
    assert max(e.end_ns() for e in launched) / 1e3 <= b
    for e in device:
        s, t = e.start_ns() / 1e3, e.end_ns() / 1e3
        assert not s < b < t, (e.name(), s, t, b)


def test_train_device_spans_cover_a_synchronised_step(cuda):
    """A step's ``train.forward``, ``train.backward`` and
    ``train.optimizer`` device times (CUDA events) sum to within 10% of the
    step's host time, closed by reading the loss."""
    import time
    from repro_torch.obs import trace
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    cfg = configs.get_smoke("deepseek_moe_16b").scaled(
        compute_dtype="float32")
    model = build(cfg, device=cuda)
    step = make_train_step(model, AdamWConfig(), device=cuda)
    opt = adamw_init(model)
    batch = {"tokens": torch.randint(0, cfg.vocab, (8, 257), device=cuda)}
    for _ in range(2):
        float(step(opt, batch)["loss"])
    for _ in range(3):
        torch.cuda.synchronize()
        with trace.collect() as tr:
            t0 = time.perf_counter()
            float(step(opt, batch)["loss"])
            host_s = time.perf_counter() - t0
        dev = {s.name: s.args["device_s"] for s in tr.spans
               if s.name.startswith("train.")}
        assert sorted(dev) == ["train.backward", "train.forward",
                               "train.optimizer"]
        assert abs(sum(dev.values()) - host_s) <= 0.1 * host_s, (dev, host_s)


# ---------------------------------------------------------------------------
# Page decode on the card: the page-unpack kernel
# ---------------------------------------------------------------------------


def _unpack_cases(rng):
    """Pages of every width and value size, with and without deleted rows and
    dictionaries, each at an offset that leaves a head and a tail."""
    from repro_torch.core.encodings.numeric import pack_bits
    from repro_torch.kernels.page_unpack import Page
    pages, at = [], 0
    for width in (0, 1, 3, 7, 8, 13, 26, 31, 32, 33, 57, 63, 64):
        for size in (1, 2, 4, 8):
            n = int(rng.integers(1, 70_000))
            codes = rng.integers(0, 2**64, n, dtype=np.uint64) \
                >> np.uint64(64 - width) if width else np.zeros(n, np.uint64)
            deleted = np.flatnonzero(rng.random(n) < 0.3) \
                if rng.random() < 0.5 else None
            entries = None
            if width and width <= 12 and rng.random() < 0.5:
                entries = rng.integers(0, 2**(8 * size), (2**width) // 2 + 1,
                                       dtype=np.uint64).astype(f"u{size}")
            rows = n if deleted is None else n - len(deleted)
            at = -(-at // 16) * 16 + size * int(rng.integers(0, 16 // size))
            pages.append(Page(pack_bits(codes, width), width, rows, size,
                              entries, deleted, at))
            at += rows * size
    return pages, at


def test_page_unpack_bit_identical(cuda):
    """The kernel against its plain version on the card, one launch for
    every page."""
    from repro_torch.kernels.page_unpack import (pack_pages, page_unpack,
                                                 page_unpack_ref)
    pages, n_out = _unpack_cases(np.random.default_rng(31))
    staging, layout = pack_pages(pages)
    staging = staging.to(cuda)
    out = torch.zeros(n_out + 16, dtype=torch.uint8, device=cuda)
    want = torch.zeros_like(out)
    before = page_unpack.launches
    page_unpack(staging, layout, out)
    torch.cuda.synchronize()
    assert page_unpack.launches == before + 1
    page_unpack_ref(staging, layout.n_pages, want)
    assert torch.equal(out, want)


def test_page_decode_on_cuda_matches_numpy(cuda, tmp_path, monkeypatch):
    """A table of the benchmark's Criteo shape at 2**19 rows (one row
    group), a 0.5% share of its users deleted at LEVEL2: every column on
    ``cuda``, dequantized BF16 features among them, bit for bit the NumPy
    route's on the CPU; one unpack launch and one dequant launch for each
    ``decode_group`` call, a page of each taking the device route."""
    from test_torch_page_decode import COLUMNS, write_criteo_like

    from repro_torch.dataset import executor
    from repro_torch.kernels.page_unpack import page_unpack
    from repro_torch.obs import metrics
    path = str(tmp_path / "criteo.bln")
    write_criteo_like(path, 2**19, 5, rows_per_group=2**19,
                      delete_share=0.005)
    device_pages = metrics.counter("bullion.decode.pages_device")
    calls = []
    real = executor.decode_group

    def counted(*a, **kw):
        before = (device_pages.value, page_unpack.launches,
                  dequant_packed.launches)
        out = real(*a, **kw)
        calls.append((device_pages.value - before[0],
                      page_unpack.launches - before[1],
                      dequant_packed.launches - before[2]))
        return out

    monkeypatch.setattr(executor, "decode_group", counted)
    for where in (None, (C("I1") > 0.5) & (C("I2") > 0.5)
                  & (C("I3") > 0.5) & (C("I4") > 0.5)):
        calls.clear()
        ds = dataset(path, device="cuda").select(COLUMNS)
        ref = dataset(path, device="cpu").select(COLUMNS)
        if where is not None:
            ds, ref = ds.where(where), ref.where(where)
        got = ds.dequantized(True).to_table()
        assert len(calls) == (1 if where is None else 2)
        assert all(routed > 0 and unpack == 1 and dq == 1
                   for routed, unpack, dq in calls), calls
        want = ref.dequantized(True)._with_kernel(False).to_table()
        for name in want:
            assert got[name].dtype == want[name].dtype
            assert np.array_equal(got[name].view(np.uint8),
                                  want[name].view(np.uint8)), name


# ---------------------------------------------------------------------------
# Decode attention on the card: the decode-attention kernel
# ---------------------------------------------------------------------------

# (B, H, Hkv, S, D, window, pos, q dtype, cache dtype): MHA at deepseek-
# moe-16b's shape, GQA 6:1 at the mixtral stage's, G = 12 (two blocks of
# heads, the second of 4), MQA with G = 16 at D = 256, D = 16 and 64, a
# cache of 5,000 slots;
# rolling buffers before and after they wrap; pos 0 and S - 1; f32 and
# bf16 caches, an f32 model
BF, F32 = torch.bfloat16, torch.float32
DECODE_CASES = {
    "dsmoe_mha": (32, 16, 16, 576, 128, 0, 544, BF, F32),
    "mixtral_gqa6": (32, 48, 8, 2176, 128, 0, 2112, BF, F32),
    "mixtral_gqa6_f32_model": (32, 48, 8, 2176, 128, 0, 2112, F32, F32),
    "starcoder2_gqa12": (2, 48, 4, 300, 128, 0, 299, BF, F32),
    "rg_mqa_d256": (2, 16, 1, 257, 256, 0, 130, BF, F32),
    "d64_bf16_cache": (4, 8, 2, 300, 64, 0, 150, BF, BF),
    "d64_f32_model": (4, 8, 2, 300, 64, 0, 211, F32, F32),
    "d128_f32_model_bf16_cache": (2, 8, 8, 200, 128, 0, 199, F32, BF),
    "d256_pos0": (2, 16, 8, 1024, 256, 0, 0, BF, F32),
    "d16_smoke": (4, 4, 2, 32, 16, 0, 31, BF, F32),
    "mqa_long_cache": (2, 4, 1, 5000, 64, 0, 4321, BF, F32),
    "rolling_before_wrap": (2, 16, 8, 64, 256, 64, 40, BF, F32),
    "rolling_after_wrap": (2, 16, 8, 64, 256, 64, 200, BF, F32),
    "rolling_f32_model": (2, 8, 2, 48, 64, 48, 100, F32, F32),
}


def _decode_inputs(cuda, B, H, Hkv, S, D, q_dtype, cache_dtype, seed=0,
                   q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(q_scale * rng.standard_normal((B, 1, H, D),
                                                      np.float32),
                        device=cuda).to(q_dtype)
    k, v = (torch.as_tensor(rng.standard_normal((B, S, Hkv, D), np.float32),
                            device=cuda).to(cache_dtype) for _ in range(2))
    return q, k, v


def _gaps(got, want, mag):
    """How far ``got`` lies from ``want``: the largest gap in ulps of q's
    dtype (bf16: 8 bits of mantissa, f32: 24) of ``mag``, each output's
    sum of p_j |v_j| (a probability the two round to neighbouring values
    moves the output by its own ulp times |v_j|, whatever the output's
    size), and the share of outputs that differ at all."""
    bits = 7 if want.dtype == torch.bfloat16 else 23
    mag = mag.float().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    gap = (got.float() - want.float()).abs() / ulp
    return float(gap.max()), float((got != want).float().mean())


# bf16: the largest gap within one ulp of p|v| (one output or one
# probability rounded to its other neighbour: summed in another order, the
# kernel and the plain version part so at a few outputs, up to 1 ulp and
# 1% of the outputs on an H100), and at most 5% of the outputs other than
# the plain version's. Leaving out the rounding of k moves 40-76% of the
# outputs (3-12 ulps where the softmax is peaked), of the probabilities
# 22-44% (test_decode_attention_keeps_the_rounding_points); at unit-normal
# queries either stays within 1 ulp, so the share is what tells them
# apart. f32: within 64 ulps, any share (a score of ~30 off by its last
# bits moves its probability by ~30 ulps)
BF16_MAX_ULPS, BF16_DIFF_SHARE, F32_MAX_ULPS = 1.0, 0.05, 64


def _within(got, want, mag) -> bool:
    worst, share = _gaps(got, want, mag)
    if want.dtype == torch.bfloat16:
        return worst <= BF16_MAX_ULPS and share <= BF16_DIFF_SHARE
    return worst <= F32_MAX_ULPS


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_attention_matches_plain(cuda, case):
    """The kernel against the model's plain decode attention on the card
    (``decode_attention_ref``: ``dot_attention`` over the cache cast to q's
    dtype), in q's dtype, within ``_within``'s limits; equal shape, dtype,
    and finite."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    B, H, Hkv, S, D, window, at, q_dtype, cache_dtype = DECODE_CASES[case]
    q, k, v = _decode_inputs(cuda, B, H, Hkv, S, D, q_dtype, cache_dtype)
    pos = torch.tensor(at, device=cuda)
    got = decode_attention(q, k, v, pos, window=window)
    want = decode_attention_ref(q, k, v, pos)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == q_dtype
    assert bool(torch.isfinite(got).all())
    mag = decode_attention_ref(q, k, v.abs(), pos)
    assert _within(got, want, mag), _gaps(got, want, mag)


def _unrounded(q, k, v, pos, part):
    """The plain version with one of its roundings left out, the faults
    the bf16 limits must catch: ``"k"`` the scores over the unrounded
    cache, ``"p"`` the unrounded probabilities times v."""
    from repro_torch.models.layers import dot_attention
    S = k.shape[1]
    slots = torch.arange(S, device=q.device)
    valid = (slots <= pos)[None, :].expand(q.shape[0], S)
    if part == "k":
        k, v = k.float(), v.to(q.dtype)
    else:
        k, v = k.to(q.dtype), v.to(q.dtype).float()
    return dot_attention(q, k, v, slots[:1], slots, causal=False,
                         kv_valid=valid).to(q.dtype)


@pytest.mark.parametrize("case", ["dsmoe_mha", "mixtral_gqa6",
                                  "starcoder2_gqa12", "rg_mqa_d256"])
def test_decode_attention_keeps_the_rounding_points(cuda, case):
    """bf16 queries 8 times the unit normal, so that the softmax is peaked
    and each score's rounding shows: the kernel within ``_within``'s
    limits of the plain version, while the plain version without the
    rounding of k, or of the probabilities, lies outside them (the kernel
    rounds where the reference does, and adds no precision)."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    B, H, Hkv, S, D, window, at, q_dtype, cache_dtype = DECODE_CASES[case]
    q, k, v = _decode_inputs(cuda, B, H, Hkv, S, D, q_dtype, cache_dtype,
                             seed=1, q_scale=8.0)
    pos = torch.tensor(at, device=cuda)
    want = decode_attention_ref(q, k, v, pos)
    mag = decode_attention_ref(q, k, v.abs(), pos)
    got = decode_attention(q, k, v, pos)
    assert _within(got, want, mag), _gaps(got, want, mag)
    for part in ("k", "p"):
        planted = _unrounded(q, k, v, pos, part)
        assert not _within(planted, want, mag), \
            (part, _gaps(planted, want, mag))


def test_decode_attention_reads_no_slot_past_pos(cuda):
    """Slots past the position hold NaN: the output stays finite and
    unchanged, so the kernel never loads them (a NaN times a zero
    probability would spread)."""
    from repro_torch.kernels.decode_attention import decode_attention
    q, k, v = _decode_inputs(cuda, 4, 8, 2, 300, 128, BF, F32)
    pos = torch.tensor(100, device=cuda)
    want = decode_attention(q, k, v, pos)
    k[:, 101:], v[:, 101:] = float("nan"), float("nan")
    got = decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_decode_attention_replays_at_every_position(cuda):
    """One launch captured in a CUDA graph at one position replays at
    others, read from the position tensor on the card: equal bit for bit
    to an eager call at each, for a full cache and a rolling buffer."""
    from repro_torch.kernels.decode_attention import decode_attention
    for S, window, positions in ((576, 0, (0, 17, 300, 575)),
                                 (64, 64, (5, 63, 64, 150))):
        q, k, v = _decode_inputs(cuda, 8, 12, 2, S, 128, BF, F32)
        pos = torch.tensor(positions[0] + 1, device=cuda)
        side = torch.cuda.Stream(cuda)
        side.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(side):
            decode_attention(q, k, v, pos, window=window)     # warm-up
        torch.cuda.current_stream(cuda).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = decode_attention(q, k, v, pos, window=window)
        for at in positions:
            pos.fill_(at)
            graph.replay()
            want = decode_attention(q, k, v, pos, window=window)
            torch.cuda.synchronize()
            assert torch.equal(out, want), (S, at)


def test_decode_attention_counts_a_call_a_layer_a_step(cuda):
    """Eager decode steps launch the kernel once an attention layer a step
    (``decode_attention.launches`` and ``bullion.attn.decode_kernel_calls``
    alike); through ``ServeEngine``, whose steps replay a captured graph,
    the counter counts every step too."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.obs import metrics
    from repro_torch.serve import ServeEngine
    from repro_torch.models.transformer import ATTN_KINDS
    model = _graph_model(cuda, "moe_capacity")
    layers = sum(n * sum(b.split(":")[0] in ATTN_KINDS for b in blocks)
                 for blocks, n in model.cfg.segments)
    assert layers
    calls = metrics.counter("bullion.attn.decode_kernel_calls")
    rng = np.random.default_rng(14)
    prompts = rng.integers(0, model.cfg.vocab, (4, 8)).astype(np.int32)
    before = (decode_attention.launches, calls.value)
    _eager_generate(model, prompts, 6, 24)
    assert (decode_attention.launches - before[0],
            calls.value - before[1]) == (6 * layers, 6 * layers)
    engine = ServeEngine(model, max_seq=24, device=cuda)
    for n in (7, 9):                 # the first captures, the second replays
        before = calls.value
        engine.generate(prompts, n)
        assert engine._kept.graph is not None
        assert calls.value - before == n * layers


def test_decode_attention_raises_on_what_it_does_not_take(cuda):
    """A head dim without an instance, fp16, a position that is not a 0-d
    int64 tensor on the card, a rolling buffer longer than its window, a
    cache view off its 4-element vectors: each raises, nothing launches."""
    from repro_torch.kernels.decode_attention import decode_attention
    q, k, v = _decode_inputs(cuda, 2, 4, 2, 64, 128, BF, F32)
    pos = torch.tensor(10, device=cuda)
    before = decode_attention.launches
    bad = [
        lambda: decode_attention(q[..., :96], k[..., :96], v[..., :96], pos),
        lambda: decode_attention(q.half(), k, v, pos),
        lambda: decode_attention(q, k, v, pos.int()),
        lambda: decode_attention(q, k, v, pos.cpu()),
        lambda: decode_attention(q, k, v, pos, window=32),
        lambda: decode_attention(q, k.view(-1)[2:2 + 2 * 63 * 2 * 128]
                                 .view(2, 63, 2, 128), v[:, :63], pos),
    ]
    for fn in bad:
        with pytest.raises(ValueError):
            fn()
    assert decode_attention.launches == before
