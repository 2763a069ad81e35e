"""The read cells on the CPU at a small size: the program's answers equal
the NumPy reference's; the control (the reference one precision below,
float8 for the stored BF16 features, put in the program's place) and the
faults a read can have (an answer altered where it is produced, half of
the rows left out, the deletes not applied) each come out not correct."""

import numpy as np
import pytest

from perfbench.gen import criteo
from perfbench.lib import harness, small
from perfbench.reference.table import TableReference, bf16_round, mismatches


@pytest.mark.parametrize("name", ["ads-scan", "ads-service"])
def test_program_equals_reference(name):
    r = small.run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert all(c["limit"] == 0 for c in r["checks"].values())


def test_bf16_rounding_is_to_nearest_even():
    import torch
    x = np.array([1.0, 1.00390625, 1.005859375, 1.0078125], np.float32)
    # 1 + 2**-8 ties to even (down), 1 + 1.5 * 2**-8 rounds up
    assert bf16_round(x).view(np.uint32).tolist() == [
        0x3F800000, 0x3F800000, 0x3F810000, 0x3F810000]
    rng = np.random.default_rng(3)
    y = (rng.standard_normal(100_000) * 10.0 ** rng.integers(-30, 30, 100_000)
         ).astype(np.float32)
    want = torch.from_numpy(y).to(torch.bfloat16).float().numpy()
    assert np.array_equal(bf16_round(y).view(np.uint32), want.view(np.uint32))


def _run_with(name, monkeypatch, fault):
    from repro_torch.dataset import core
    real = core.Dataset.to_table

    def broken(self, *a, **kw):
        return fault(real(self, *a, **kw))
    monkeypatch.setattr(core.Dataset, "to_table", broken)
    return small.run(name)


def _alter(table):
    out = dict(table)
    for k, v in out.items():
        if len(v):
            v = np.array(v, copy=True)
            v.view(np.uint8)[0] ^= 1
            out[k] = v
            break
    return out


def _half(table):
    return {k: v[: len(v) // 2] for k, v in table.items()}


@pytest.mark.parametrize("name", ["ads-scan", "ads-service"])
@pytest.mark.parametrize("fault", [_alter, _half], ids=["altered", "half"])
def test_faults_are_not_correct(name, fault, monkeypatch):
    r = _run_with(name, monkeypatch, fault)
    assert not r["correct"], r["checks"]


def test_deletes_not_applied_are_not_correct(monkeypatch):
    from repro_torch.dataset import core
    monkeypatch.setattr(core.Dataset, "delete_where",
                        lambda self, predicate, level=None: None)
    r = small.run("ads-scan")
    assert not r["correct"], r["checks"]


def test_control_one_precision_below_is_not_correct():
    """Float8 in place of the stored BF16 features (and, apart, the deletes
    left out): the reference's own answers differ from the configuration's
    in every case of the scan's traffic."""
    cell = small.small_cell("ads-scan")
    cfg = cell.config
    cols = criteo.columns(cfg, 2**31 + 1)
    victims = criteo.victims(cfg, cols, 2**31 + 1)
    want = TableReference(cols, criteo.DENSE, victims)
    for control in (TableReference(cols, criteo.DENSE, victims,
                                   precision="fp8"),
                    TableReference(cols, criteo.DENSE, victims,
                                   delete=False)):
        for p in cell.traffic["predicates"]:
            a = control.query(cell.traffic["columns"], p["where"])
            b = want.query(cell.traffic["columns"], p["where"])
            assert mismatches(a, b) > 0, p["name"]


def test_evaluated_groups_follow_the_zone_maps():
    """The benchmark's own count of a scan's work: the pruned predicate
    keeps only the last row group."""
    from perfbench.lib import tables
    cell = small.small_cell("ads-scan")
    cfg = cell.config
    cols = criteo.columns(cfg, 7)
    t = tables.Table(cfg=cfg, columns=cols,
                     victims=criteo.victims(cfg, cols, 7), tmp="", path="")
    groups = cfg["rows"] // cfg["rows_per_group"]
    where = {p["name"]: p["where"] for p in cell.traffic["predicates"]}
    assert len(tables.evaluated(t, where["last_6_days"])) == 1
    assert len(tables.evaluated(t, where["dense_4"])) == groups
    assert harness.NAME.match("last_6_days")
