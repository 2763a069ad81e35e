"""The readers of the program's model-path spans: the decode readers on
synthetic timelines (spans placed on the profiler's clock by
``obs.trace.profiler_us``, device ops beside them), and every new reader
through a traced run of the small model cells on the CPU."""

import pytest

from perfbench.lib import harness, small
from repro_torch.obs import trace
from repro_torch.obs.trace import SpanRecord

DECODE_READERS = ("decode.launches_per_step", "decode.idle_attn_ms",
                  "decode.idle_moe_ms")
TRAIN_READERS = ("train.forward_ms", "train.backward_ms",
                 "train.adamw_roofline", "loader.wait_ms")
BASE = trace.profiler_us(SpanRecord("zero", "t", 0.0, 0.0, 0, "", {}))


def _span(name, a, b, **args):
    """A span from ``a`` to ``b`` us after the tracer's zero."""
    return SpanRecord(name, "t", a / 1e6, (b - a) / 1e6, 1, "main", args)


def _ctx(spans, ops):
    kernels = [(f"k{i}", BASE + a, b - a) for i, (a, b) in enumerate(ops)]
    return harness.TraceCtx(cell=None, records={}, spans=spans,
                            kernels=kernels, busy_s=1.0, window_s=1.0)


def _read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


# two decode calls, 2 and 1 steps; attention and MoE spans in both, one of
# each nested in another of its name, and attention between the calls
SPANS = [
    _span("serve.decode", 0, 1000, steps=2, batch=4),
    _span("serve.decode", 2000, 2600, steps=1, batch=4),
    _span("layer.attn", 50, 600), _span("layer.attn", 200, 250),
    _span("layer.moe", 600, 950), _span("moe.route", 610, 700),
    _span("layer.attn", 1100, 1900),
    _span("layer.attn", 2000, 2300), _span("layer.moe", 2300, 2600),
]
# two ops straddle the first call's edges; two overlap
OPS = [(-50, 100), (300, 400), (350, 500), (900, 1100), (2100, 2200),
       (2500, 2550)]


def test_launches_count_the_ops_inside_decode_spans():
    """Ops straddling a span's edge are not the span's."""
    assert _read("decode.launches_per_step", _ctx(SPANS, OPS)) == \
        pytest.approx(4 / 3)


@pytest.mark.parametrize("name, idle_us", [
    # idle in the calls: 100-300, 500-900; 2000-2100, 2200-2500, 2550-2600
    ("decode.idle_attn_ms", 200 + 100 + 100 + 100),
    ("decode.idle_moe_ms", 300 + 200 + 50),
])
def test_idle_by_layer_is_clipped_to_decode_spans(name, idle_us):
    """Device ops straddling a call's edges are clipped to it, nested host
    spans count once, and idle time between calls is not counted."""
    assert _read(name, _ctx(SPANS, OPS)) == \
        pytest.approx(idle_us / 1e3 / 3, abs=1e-5)


def test_an_idle_device_is_idle_in_every_host_span():
    """No op inside a call: its whole length under each host span."""
    spans = [_span("serve.decode", 0, 100, steps=1),
             _span("layer.attn", 0, 40), _span("layer.moe", 40, 100)]
    ctx = _ctx(spans, [(200, 300)])
    assert _read("decode.launches_per_step", ctx) == 0
    assert _read("decode.idle_attn_ms", ctx) == pytest.approx(0.04, abs=1e-5)
    assert _read("decode.idle_moe_ms", ctx) == pytest.approx(0.06, abs=1e-5)


@pytest.mark.parametrize("name", DECODE_READERS)
def test_decode_readers_without_ops_or_spans_read_nothing(name, monkeypatch):
    assert _read(name, _ctx(SPANS, [])) is None
    assert _read(name, _ctx([], OPS)) is None
    # a program that cannot place its spans on the profiler's timeline
    monkeypatch.delattr(trace, "profiler_us")
    assert _read(name, _ctx(SPANS, OPS)) is None


def test_train_readers_read_device_time_a_step():
    rec = {"step_s": [1.0, 1.0], "cfg": {
        "hidden_size": 4, "vocab_size": 10, "num_hidden_layers": 1,
        "num_attention_heads": 1, "num_key_value_heads": 1, "head_dim": 4,
        "first_k_dense_replace": 1, "n_routed_experts": 2,
        "moe_intermediate_size": 2, "n_shared_experts": 1,
        "intermediate_size": 8, "num_experts_per_tok": 1}}
    spans = []
    for name, s in (("train.forward", 0.3), ("train.backward", 0.9),
                    ("train.optimizer", 0.1)):
        spans += [SpanRecord(name, "train", 0.0, 9.0, 1, "main",
                             {"device_s": s}) for _ in range(2)]
    spans += [SpanRecord("loader.wait", "loader", 0.0, d, 1, "main", {})
              for d in (1e-4, 3e-4, 2e-3)]
    ctx = harness.TraceCtx(cell=None, records=rec, spans=spans, kernels=[],
                           busy_s=None, window_s=1.0)
    assert _read("train.forward_ms", ctx) == pytest.approx(300.0)
    assert _read("train.backward_ms", ctx) == pytest.approx(900.0)
    # embedding and head, attention (q, k, v, o, 2 norms), dense MLP, norm
    n = 2 * 4 * 10 + (4 * 3 * 4 + 4 * 4 + 2 * 4) + 3 * 4 * 8 + 4
    assert _read("train.adamw_roofline", ctx) == pytest.approx(
        100.0 * 32 * n / 3.35e12 / 0.1)
    assert _read("loader.wait_ms", ctx) == pytest.approx(0.3)
    # a device span left unresolved reads nothing
    spans[0].args.pop("device_s")
    assert _read("train.forward_ms", ctx) is None


def test_traced_train_run_reads_the_train_spans():
    r = small.run("dsmoe-train", seconds=0.5, trace=True)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    for name in TRAIN_READERS:
        assert m[name]["value"] > 0, name
    assert m["train.adamw_roofline"]["value"] < 100.0


def test_traced_generate_run_reads_no_device_metric_on_the_cpu():
    """On the CPU the trace has no device op: the decode readers, which
    read device ops, leave their metrics out; the host readers read."""
    r = small.run("dsmoe-generate", trace=True)
    assert r["correct"], r["checks"]
    for name in DECODE_READERS:
        assert name not in r["metrics"]
    assert r["metrics"]["decode.step_ms"]["value"] > 0
