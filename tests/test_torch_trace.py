"""The port's tracer (``obs/trace.py``) on the CPU: spans on the profiler's
clock (``profiler_us``), device spans (``device_span``: disabled, on the
CPU, and resolved from CUDA events, here faked), and the spans of the model
path: where they open, how often, and that with no tracer installed a scan,
a decode and a training step allocate no span."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import configs
from repro_torch.data import BullionLoader, write_lm_corpus
from repro_torch.dataset import dataset
from repro_torch.models.zoo import build
from repro_torch.obs import trace
from repro_torch.serve import ServeEngine
from repro_torch.train import AdamWConfig, adamw_init, make_train_step

TRACE_PY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "obs", "trace.py")


@pytest.fixture(autouse=True)
def _no_tracer():
    """Each test starts with no tracer installed and restores the slot."""
    prev = trace.current()
    trace.install(None)
    yield
    trace.install(prev)


def test_span_encloses_a_profiler_range_on_its_timeline():
    """A span opened just before a ``record_function`` range and closed
    just after it encloses the range on the profiler's own timeline,
    within 50 us, once placed there by ``profiler_us``."""
    x = torch.randn(256, 256)
    with trace.collect() as tr, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with trace.span("probe", i=i):
                with record_function(f"probe.range{i}"):
                    for _ in range(4):
                        x = torch.tanh(x @ x)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe.range")}
    spans = [s for s in tr.spans if s.name == "probe"]
    assert len(spans) == len(ranges) == 5
    for rec in spans:
        ev = ranges[f"probe.range{rec.args['i']}"]
        start = trace.profiler_us(rec)
        end = start + rec.dur * 1e6
        assert start <= ev.start_ns() / 1e3 + 50.0, \
            (start, ev.start_ns() / 1e3)
        assert end >= ev.end_ns() / 1e3 - 50.0, (end, ev.end_ns() / 1e3)


def test_wall_form_of_a_record_keeps_its_instant():
    """``span_to_dict(wall=True)`` gives the span's instant on the wall
    clock, and ``span_from_dict(wall=True)`` takes it back."""
    with trace.collect() as tr:
        with trace.span("w"):
            pass
    rec = tr.spans[0]
    d = trace.span_to_dict(rec, wall=True)
    assert d["ts"] * 1e6 == pytest.approx(trace.profiler_us(rec), abs=1.0)
    assert trace.span_from_dict(d, wall=True).ts == pytest.approx(rec.ts,
                                                                  abs=1e-6)


def test_disabled_device_span_allocates_and_imports_nothing():
    before, mods = trace.allocations(), set(sys.modules)
    with trace.device_span("train.forward", "train", k=1) as sp:
        assert sp is trace.NULL_SPAN and not sp.enabled
    assert trace.allocations() == before
    assert set(sys.modules) == mods


def test_tracer_runs_without_torch():
    """``obs/trace.py`` loaded alone in a fresh interpreter: device spans
    without torch read their own duration, and nothing imports torch."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('t', {TRACE_PY!r})\n"
        "t = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(t)\n"
        "with t.device_span('a'):\n"
        "    pass\n"
        "with t.collect() as tr:\n"
        "    with t.device_span('b', 'c', n=2):\n"
        "        sum(range(10000))\n"
        "rec = tr.spans[0]\n"
        "assert rec.args == {'n': 2, 'device_s': rec.dur}, rec.args\n"
        "assert t.allocations() == 1\n"
        "assert 'torch' not in sys.modules\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60)
    assert p.returncode == 0, p.stderr


def test_device_span_on_the_cpu_reads_its_duration():
    assert not torch.cuda.is_initialized()
    with trace.collect() as tr:
        with trace.device_span("train.optimizer", "train") as sp:
            assert sp.enabled
            torch.randn(64, 64) @ torch.randn(64, 64)
    (rec,) = tr.spans
    assert rec.args["device_s"] == rec.dur > 0


class _FakeEvent:
    """Stands for ``torch.cuda.Event``: ``elapsed_time`` is 2.5 ms from
    start to end; ``synchronize`` counts its calls."""
    syncs = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.recorded = False

    def record(self):
        self.recorded = True

    def synchronize(self):
        type(self).syncs += 1

    def elapsed_time(self, end):
        assert self.recorded and end.recorded
        return 2.5


def _fake_torch(capturing: bool):
    """Stands for ``torch`` with CUDA initialised, its current stream being
    captured into a CUDA graph or not."""
    return types.SimpleNamespace(cuda=types.SimpleNamespace(
        is_initialized=lambda: True, Event=_FakeEvent,
        is_current_stream_capturing=lambda: capturing))


def test_pending_device_times_resolve_when_collect_closes(monkeypatch):
    """Where CUDA is initialised, a device span's ``device_s`` waits for
    its events until the ``collect()`` scope closes; the record forwarded
    to the enclosing tracer is the same, so it carries the time too, and
    nothing is waited for twice."""
    monkeypatch.setitem(sys.modules, "torch", _fake_torch(capturing=False))
    monkeypatch.setattr(_FakeEvent, "syncs", 0)
    outer = trace.enable()
    with trace.collect() as inner:
        with trace.device_span("train.backward", "train", step=3):
            pass
        (rec,) = inner.spans
        assert "device_s" not in rec.args and _FakeEvent.syncs == 0
    assert rec.args == {"step": 3, "device_s": 2.5e-3}
    assert outer.spans == [rec] and _FakeEvent.syncs == 1
    outer.resolve()
    assert _FakeEvent.syncs == 1
    # a tracer installed alone resolves when it is aggregated
    with trace.device_span("train.forward", "train"):
        pass
    assert "device_s" not in outer.spans[-1].args
    agg = outer.aggregate()
    assert agg["train.forward"].args["device_s"] == 2.5e-3
    assert _FakeEvent.syncs == 2


def test_device_span_on_a_capturing_stream_is_a_host_span(monkeypatch):
    """While the current stream is captured into a CUDA graph, a device
    span records no event (an event there would break the capture) and no
    ``device_s``: it is a host span alone, and nothing waits on it."""
    def no_event(enable_timing=False):
        raise AssertionError("an event recorded during a capture")
    monkeypatch.setitem(sys.modules, "torch", _fake_torch(capturing=True))
    monkeypatch.setattr(_FakeEvent, "syncs", 0)
    with trace.collect() as tr:
        monkeypatch.setattr(_FakeEvent, "__init__", no_event)
        with trace.device_span("moe.experts", "model", path="grouped"):
            pass
    (rec,) = tr.spans
    assert rec.args == {"path": "grouped"} and rec.dur >= 0
    assert _FakeEvent.syncs == 0


# ---------------------------------------------------------------------------
# the model path's spans
# ---------------------------------------------------------------------------


def _moe_model():
    cfg = configs.get_smoke("deepseek-moe-16b").scaled(
        compute_dtype="float32")
    return cfg, build(cfg, device="cpu")


def _counts(spans):
    out: dict = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def _moe_layers(cfg):
    return sum(rep * sum(b.endswith(":moe") for b in blocks)
               for blocks, rep in cfg.segments)


def test_decode_spans():
    """``generate`` of n tokens: one ``serve.decode`` span (its steps and
    batch, and on the CPU every step eager), a ``layer.attn`` span a layer a call of the model (the prefill
    and each step), a ``layer.moe`` span a MoE layer, each holding one
    span of each MoE stage; every decode-step layer inside
    ``serve.decode``."""
    cfg, model = _moe_model()
    n, B = 3, 2
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, 5)) \
        .astype(np.int32)
    engine = ServeEngine(model, max_seq=16, device="cpu")
    with trace.collect() as tr:
        engine.generate(prompts, n)
    c = _counts(tr.spans)
    moe = _moe_layers(cfg)
    assert moe > 0
    assert c["serve.decode"] == 1
    assert c["layer.attn"] == cfg.n_layers * (n + 1)
    for name in ("layer.moe", "moe.route", "moe.dispatch", "moe.experts",
                 "moe.combine"):
        assert c[name] == moe * (n + 1), name
    (dec,) = [s for s in tr.spans if s.name == "serve.decode"]
    assert dec.args == {"steps": n, "batch": B, "graph_steps": 0,
                        "eager_steps": n}
    inside = [s for s in tr.spans if s.name == "layer.attn"
              and dec.ts <= s.ts and s.ts + s.dur <= dec.ts + dec.dur]
    assert len(inside) == cfg.n_layers * n
    for m in (s for s in tr.spans if s.name == "layer.moe"):
        parts = [s for s in tr.spans if s.name.startswith("moe.")
                 and m.ts <= s.ts and s.ts + s.dur <= m.ts + m.dur]
        assert sorted(s.name for s in parts) == [
            "moe.combine", "moe.dispatch", "moe.experts", "moe.route"]


def test_train_step_spans():
    """A step: one ``train.forward``, ``train.backward`` and
    ``train.optimizer`` span, in that order, each with ``device_s`` (its
    ``dur`` on the CPU); ``layer.attn`` twice a layer (the forward and the
    backward's recompute, inside ``train.backward``)."""
    cfg, model = _moe_model()
    step = make_train_step(model, AdamWConfig(), device="cpu")
    opt = adamw_init(model)
    batch = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 9)).astype(np.int32)}
    with trace.collect() as tr:
        step(opt, batch)
    names = [s.name for s in tr.spans if s.name.startswith("train.")]
    assert names == ["train.forward", "train.backward", "train.optimizer"]
    for s in tr.spans:
        if s.name.startswith("train."):
            assert s.args["device_s"] == s.dur > 0
    bwd = next(s for s in tr.spans if s.name == "train.backward")
    attn = [s for s in tr.spans if s.name == "layer.attn"]
    assert len(attn) == 2 * cfg.n_layers
    assert sum(bwd.ts <= s.ts <= bwd.ts + bwd.dur for s in attn) \
        == cfg.n_layers


def test_loader_wait_spans(tmp_path):
    path = str(tmp_path / "corpus.bln")
    write_lm_corpus(path, n_docs=32, doc_len=64, rows_per_group=8)
    loader = BullionLoader(path, batch_size=2, seq_len=16, device="cpu")
    try:
        it = iter(loader)
        with trace.collect() as tr:
            for _ in range(3):
                next(it)
    finally:
        loader.close()
    waits = [s for s in tr.spans if s.name == "loader.wait"]
    assert len(waits) == 3 and all(s.args == {"rank": 0} for s in waits)


def test_disabled_paths_allocate_no_span(tmp_path):
    """With no tracer installed, a scan, a ``generate`` call, a training
    step and the loader's batches create no span at all."""
    cfg, model = _moe_model()
    path = str(tmp_path / "corpus.bln")
    write_lm_corpus(path, n_docs=32, doc_len=64, rows_per_group=8)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (2, 5)) \
        .astype(np.int32)
    before = trace.allocations()
    dataset(path, device="cpu").select(["doc_id", "quality"]).to_table()
    ServeEngine(model, max_seq=16, device="cpu").generate(prompts, 2)
    step = make_train_step(model, AdamWConfig(), device="cpu")
    step(adamw_init(model), {"tokens": np.concatenate(
        [prompts, prompts], axis=1)})
    loader = BullionLoader(path, batch_size=2, seq_len=16, device="cpu")
    try:
        it = iter(loader)
        next(it), next(it)
    finally:
        loader.close()
    assert trace.allocations() == before
