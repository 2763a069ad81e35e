"""The cell ``mixtral-stage-generate`` on the CPU at a mixtral-shaped small
size (GQA 4:2, 8 experts, top 2, no shared expert, two chunks an expert,
capacity factor E / k as the cell runs it): its files and the program's
grouped path agree with the blocked reference, its two new per-layer
metrics read a number, an altered served token is not correct, the float8
control reads a far wider gap, and the stage bridge gives every parameter
storage of its own."""

import copy
import json

import numpy as np
import pytest
import torch

from perfbench.lib import harness, small, stage_models

CELL = "mixtral-stage-generate"
MODEL = dict(small.MODEL, num_key_value_heads=2, n_shared_experts=0)
TRAFFIC = {"batch": 4, "prompt_len": 16, "new_tokens": 8, "max_seq": 24}


def small_stage() -> harness.Cell:
    cell = harness.find_cell(harness.load_manifest(), CELL)
    cell.config = dict(copy.deepcopy(cell.config), **MODEL)
    cell.traffic = dict(copy.deepcopy(cell.traffic), **TRAFFIC)
    assert cell.config["capacity_factor"] == 4.0
    return cell


def run(trace: bool = False) -> dict:
    return harness.run_cell(small_stage(), seed=2**31 + 29, seconds=1.0,
                            trace=trace, device="cpu",
                            log=lambda *a, **k: None, check_imports=False)


def test_blocked_reference_equals_the_whole_one():
    """Attention a batch row at a time gives the whole reference's served
    logits, in f32 up to the order of the sums (the float8 control scales
    each row by its own largest magnitude, so it differs by its rounding)."""
    from perfbench.reference import moe_lm, moe_lm_blocked
    cfg = small_stage().config
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg["vocab_size"], (3, 20)))
    args = (cfg, 2**31 + 5, "cpu", torch.bfloat16)
    with torch.no_grad():
        whole = moe_lm.Reference(*args).served_logits(tokens, 14)
        blocked = moe_lm_blocked.Reference(*args).served_logits(tokens, 14)
    assert blocked.shape == whole.shape == (3, 7, cfg["vocab_size"])
    assert float((blocked - whole).abs().max()) \
        <= 1e-5 * float(whole.abs().max())


def test_cell_is_correct_and_its_metrics_read():
    """Untraced: correct, with ``gen_tokens_per_s`` and ``setup_s``; traced:
    correct, and ``moe.grouped_roofline`` (the grouped ``moe.experts`` spans)
    and ``prefill.mfu_pct`` read a number."""
    from repro_torch.obs import metrics
    calls = metrics.counter("bullion.moe.grouped_calls").value
    plain = run()
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"gen_tokens_per_s", "setup_s"}
    assert plain["checks"]["served_mean_gap"]["value"] < 0.01
    assert metrics.counter("bullion.moe.grouped_calls").value > calls
    traced = run(trace=True)
    assert traced["correct"], traced["checks"]
    for name in ("moe.grouped_roofline", "prefill.mfu_pct", "decode.step_ms"):
        assert traced["metrics"][name]["value"] > 0, name


def test_a_windows_records_hold_its_own_calls():
    """The readers of the untraced window (``decode.step_ms``,
    ``prefill.mfu_pct``) read its calls, not the traced window's after it."""
    drv = harness.load_module("drivers", "generate_stage")
    state = drv.setup(small_stage(), 2**31 + 3, torch.device("cpu"),
                      harness.Stages(0.0))
    first, second = drv.window(state, 0.2), drv.window(state, 0.2)
    assert len(first.records["calls"]) == first.attempted >= 1
    assert len(second.records["calls"]) == second.attempted >= 1
    assert len(state.calls) == first.attempted + second.attempted


def test_altered_token_is_not_correct(monkeypatch):
    from repro_torch.serve import lm
    real = lm.ServeEngine.generate

    def broken(self, *a, **kw):
        out = real(self, *a, **kw)
        toks = out["tokens"].copy()
        toks[0, 1] = (toks[0, 1] + 1) % self.model.cfg.vocab
        return dict(out, tokens=toks)
    monkeypatch.setattr(lm.ServeEngine, "generate", broken)
    r = run()
    assert not r["correct"], r["checks"]


def test_float8_control_reads_a_wider_gap():
    """The blocked reference at float8 in the served model's place: by the
    cell's own check, the tokens it puts first lie far further below the
    reference's best than the program's, on average
    (``perfbench/stage_controls.py`` at the cell's size)."""
    from perfbench.stage_controls import generate
    out = generate(small_stage(), 2**31 + 99, torch.device("cpu"))
    gap = "served_mean_gap"
    assert out["control"][gap][0] > 3 * out["program"][gap][0], out


@pytest.mark.gpu
def test_float8_control_is_not_correct_at_the_cells_size():
    """At the cell's own size on the card, ``generate_stage.check`` with
    the committed limits file holds for the program's served tokens and
    not for the float8 control's picks in their place. (At a small size on
    the CPU the logits, and so the gaps, are far smaller than the limit.)
    On an H100: ``pytest -m gpu -s perfbench/test_perfbench_stage.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's 50.9 GB of weights")
    from perfbench.stage_controls import generate
    cell = harness.find_cell(harness.load_manifest(), CELL)
    out = generate(cell, 2**31 + 2929, torch.device("cuda"))
    print(json.dumps(out))
    assert out["program"]["correct"], out
    assert not out["control"]["correct"], out


def test_stage_bridge_gives_each_parameter_its_own_storage():
    """No parameter shares storage with another or with a layer's draw; the
    values are the generic bridge's."""
    from perfbench.lib import models
    cfg = small_stage().config
    model = stage_models.build(cfg, 7, "cpu", torch.bfloat16)
    params = dict(model.named_parameters())
    assert all(stage_models.owns_storage(p) for p in params.values())
    ptrs = {p.untyped_storage().data_ptr() for p in params.values()}
    assert len(ptrs) == len(params)
    generic = dict(models.build(cfg, 7, "cpu", torch.bfloat16)
                   .named_parameters())
    assert not all(stage_models.owns_storage(p) for p in generic.values())
    for name, p in params.items():
        assert torch.equal(p, generic[name]), name
