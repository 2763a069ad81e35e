"""The frozen counting functions against values worked out by hand."""

import pytest

from perfbench.counts import model, reads
from perfbench.counts.peaks import FLOPS, HBM_BYTES_PER_S

# a tiny configuration whose counts are easy to work out
CFG = {"hidden_size": 4, "vocab_size": 10, "num_hidden_layers": 2,
       "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 2,
       "first_k_dense_replace": 1, "n_routed_experts": 4,
       "moe_intermediate_size": 3, "n_shared_experts": 1,
       "num_experts_per_tok": 2, "intermediate_size": 5,
       "compute_dtype": "float32"}


def test_peaks():
    assert HBM_BYTES_PER_S == 3.35e12
    assert FLOPS["float32"] == 67e12 and FLOPS["bfloat16"] == 989e12


def test_read_bytes():
    assert reads.filter_bytes(4, 1000) == 4 * 1000 * 4 + 1000
    assert reads.dequant_bytes(13, 100) == 13 * 100 * (2 + 4)


def test_live_pairs():
    assert model.live_pairs(1) == 1
    assert model.live_pairs(4) == 1 + 2 + 3 + 4
    assert model.live_pairs(4096) == 8390656


def test_params_by_hand():
    p = model.params(CFG)
    # attention a layer: q 4x4, k 4x2, v 4x2, o 4x4, two norms of 4
    attn = 16 + 8 + 8 + 16 + 8
    dense = 3 * 4 * 5
    moe_other = 4 * 4 + 3 * 4 * 3        # router, one shared expert
    routed = 4 * 3 * 4 * 3               # 4 experts of 3 * 4 * 3
    assert p["routed"] == routed
    assert p["other"] == 2 * attn + dense + moe_other + 4
    assert p["embed"] == p["head"] == 40
    assert p["active"] == p["other"] + routed * 2 / 4 + 40


def test_train_flops_by_hand():
    p = model.params(CFG)
    B, S = 2, 3
    attn = 3 * (4 * 2 * 2 * B * 6) * 2   # 3 x fwd (4 D H B pairs), 2 layers
    assert model.train_flops(CFG, B, S) == pytest.approx(
        6 * p["active"] * B * S + attn)
    assert model.flash_flops(CFG, B, S) == 4 * 2 * 2 * B * 6


def test_decode_step_by_hand():
    p = model.params(CFG)
    B, pos = 2, 5
    flops, nbytes = model.decode_step(CFG, B, pos)
    assert flops == 2 * p["active"] * B + 4 * 2 * 2 * 6 * B * 2
    touched = 1 - (1 - 2 / 4) ** 2
    weights = (p["other"] + p["head"] + p["routed"] * touched) * 2
    cache = 2 * B * 6 * 1 * 2 * 2 * 4
    assert nbytes == pytest.approx(weights + B * 4 * 2 + cache)


def test_full_size_counts():
    """The sizes the issue and ``PERF.md`` state for deepseek-moe-16b."""
    import json
    from perfbench.lib.harness import ROOT
    stage = json.loads((ROOT / "perfbench/configs/deepseek-moe-16b-stage.json")
                       .read_text())
    full = json.loads((ROOT / "perfbench/configs/deepseek-moe-16b.json")
                      .read_text())
    ps = model.params(stage)
    assert sum(ps[k] for k in ("embed", "head", "routed", "other")) \
        == pytest.approx(2.855e9, rel=1e-3)
    assert ps["active"] == pytest.approx(638.2e6, rel=1e-3)
    assert model.train_flops(stage, 2, 4096) == pytest.approx(33.43e12,
                                                             rel=1e-3)
    pf = model.params(full)
    assert sum(pf[k] for k in ("embed", "head", "routed", "other")) \
        == pytest.approx(16.376e9, rel=1e-3)


@pytest.mark.parametrize("names, units", [
    (["void flash_fwd_simt<C>(Args, int)"] * 3, 3.0),
    (["flash_fwd_simt", "flash_bwd_simt"], 3.5),
    (["flash_fwd_simt", "flash_attn_other"], None),
])
def test_flash_roofline_counts_launches_by_kind(names, units):
    """The training flash share counts each launch in the trace by its
    kind (a backward launch is 2.5 forwards' products), over the
    launches' device time; a launch of an unknown kind leaves it unread."""
    from perfbench.lib import harness
    reader = harness.load_module("metrics", "train.flash_roofline")
    kernels = [(n, 0.0, 2000.0) for n in names] + [("sgemm", 0.0, 9e6)]
    ctx = harness.TraceCtx(
        cell=None, records={"step_s": [1.0], "cfg": CFG, "batch": 2,
                            "seq": 3},
        spans=[], kernels=kernels, busy_s=1.0, window_s=1.0)
    got = reader.read(ctx)
    if units is None:
        assert got is None
        return
    need = units * 4 * 2 * 2 * 2 * 6         # D H B live_pairs(3)
    seconds = len(names) * 2000.0 / 1e6
    assert got == pytest.approx(100.0 * need / FLOPS["float32"] / seconds)


def test_host_clock_readers_read_the_untraced_window():
    """Readings by the host's clock come from the untraced window's
    records, not from the traced window's, which the profiler slows."""
    from perfbench.lib import harness
    calls = [{"decode_s": 0.64}, {"decode_s": 0.96}]
    plain = {"calls": calls, "new_tokens": 8}
    traced = {"calls": [{"decode_s": 9.0}], "new_tokens": 8}
    ctx = harness.TraceCtx(cell=None, records=traced, spans=[], kernels=[],
                           busy_s=1.0, window_s=1.0, plain=plain,
                           plain_s=2.0)
    step = harness.load_module("metrics", "decode.step_ms").read(ctx)
    assert step == pytest.approx((0.64 + 0.96) * 1e3 / 16)
    ctx.plain = {"step_s": [0.5, 0.5, 0.5, 0.5], "cfg": CFG, "batch": 2,
                 "seq": 3}
    mfu = harness.load_module("metrics", "train.mfu_pct").read(ctx)
    assert mfu == pytest.approx(100.0 * 4 * model.train_flops(CFG, 2, 3)
                                / 2.0 / FLOPS["float32"])
