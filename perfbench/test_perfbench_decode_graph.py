"""The readers of a decode step replayed from a CUDA graph: the share of
steps replayed (``decode.graph_share``, from the ``serve.decode`` spans'
args) and the decode steps' grouped expert kernels against their roofline
(``decode.grouped_roofline``), on the synthetic timelines of
``test_perfbench_spans`` and through a traced run of the small generate
cell on the CPU."""

import pytest

from perfbench.lib import harness, small
from perfbench.test_perfbench_spans import BASE, OPS, SPANS, _ctx, _read, \
    _span
from repro_torch.obs import trace


def test_graph_share_reads_graph_steps_over_steps():
    """Two calls, the first capturing after 2 eager warm-up steps (6 of 8
    steps replayed), the second replayed whole; no device op is needed."""
    spans = [_span("serve.decode", 0, 100, steps=8, batch=4, graph_steps=6,
                   eager_steps=0),
             _span("serve.decode", 200, 300, steps=8, batch=4,
                   graph_steps=8, eager_steps=0),
             _span("layer.attn", 0, 40)]
    assert _read("decode.graph_share", _ctx(spans, [])) == \
        pytest.approx(100.0 * 14 / 16)
    eager = [_span("serve.decode", 0, 100, steps=3, graph_steps=0,
                   eager_steps=3)]
    assert _read("decode.graph_share", _ctx(eager, [])) == 0.0


def test_graph_share_reads_nothing_without_the_programs_args():
    """A program whose ``serve.decode`` spans carry no ``graph_steps``, or
    a window with no decode span, reads nothing and raises nothing."""
    assert _read("decode.graph_share", _ctx(SPANS, OPS)) is None
    assert _read("decode.graph_share", _ctx([], OPS)) is None
    mixed = SPANS[:1] + [_span("serve.decode", 2000, 2600, steps=1,
                               graph_steps=1, eager_steps=0)]
    assert _read("decode.graph_share", _ctx(mixed, OPS)) is None


# torch's CUTLASS grouped GEMM, as the profiler names it (cut short); a
# MoE configuration of 3 layers, the first dense
GROUPED = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_"
           "for_sm9xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShape")
MOE_CFG = {"hidden_size": 64, "moe_intermediate_size": 128,
           "num_experts_per_tok": 2, "n_routed_experts": 8,
           "num_hidden_layers": 3, "first_k_dense_replace": 1,
           "torch_dtype": "bfloat16", "compute_dtype": "bfloat16"}


def _named_ctx(spans, ops, records):
    kernels = [(n, BASE + a, b - a) for n, a, b in ops]
    return harness.TraceCtx(cell=None, records=records, spans=spans,
                            kernels=kernels, busy_s=1.0, window_s=1.0)


def test_decode_grouped_roofline_reads_grouped_kernels_inside_decode():
    """The least time of the calls' 3 steps (batch 4, 2 MoE layers, 4
    tokens and 8 pairs a layer) over the grouped kernels that lie wholly
    inside the calls (350 us): not one straddling a call's edge, nor one
    between the calls (a prefill's), nor another kernel inside."""
    from perfbench.counts.grouped import grouped_least_s
    ops = [(GROUPED, 100, 300), (GROUPED, 400, 500), (GROUPED, 2100, 2150),
           (GROUPED, 900, 1100), (GROUPED, 1200, 1800), ("nvjet", 600, 700)]
    got = _read("decode.grouped_roofline",
                _named_ctx(SPANS, ops, {"cfg": MOE_CFG}))
    assert got == pytest.approx(
        100.0 * 3 * 2 * grouped_least_s(MOE_CFG, 4, 8, 8) / 350e-6)


def test_decode_grouped_roofline_without_its_kernels_reads_nothing():
    """No grouped kernel (the capacity path), grouped kernels outside every
    decode span alone (a prefill's), no decode span, or no configuration:
    nothing, and nothing raised."""
    cfg = {"cfg": MOE_CFG}
    outside = [(GROUPED, 1200, 1800)]
    for spans, ops, rec in ((SPANS, [("nvjet", 100, 200)], cfg),
                            (SPANS, outside, cfg),
                            ([], [(GROUPED, 100, 300)], cfg),
                            (SPANS, [(GROUPED, 100, 300)], {})):
        assert _read("decode.grouped_roofline",
                     _named_ctx(spans, ops, rec)) is None


def test_decode_grouped_roofline_without_ops_or_spans_reads_nothing(
        monkeypatch):
    """As the other decode readers: no op, no span, or a program that
    cannot place its spans on the profiler's timeline reads nothing."""
    assert _read("decode.grouped_roofline", _ctx(SPANS, [])) is None
    assert _read("decode.grouped_roofline", _ctx([], OPS)) is None
    monkeypatch.delattr(trace, "profiler_us")
    assert _read("decode.grouped_roofline", _ctx(SPANS, OPS)) is None


def test_traced_generate_run_on_the_cpu_replays_nothing():
    """On the CPU no step is captured: ``decode.graph_share`` reads 0, and
    the grouped kernels' reader, which reads device ops, leaves its metric
    out."""
    r = small.run("dsmoe-generate", trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["decode.graph_share"]["value"] == 0.0
    assert "decode.grouped_roofline" not in r["metrics"]
