"""The model cells on the CPU at a small size (deepseek-moe-16b's block at
smoke widths: 8 experts, top 2, one shared, a dense first layer): the
program's served tokens and training steps agree with the plain
reference; the faults a model cell can have each come out not correct;
the float8 control of the served model reads a far wider gap than the
program. The TF32 control of training needs the card
(``test_perfbench_card.py``)."""

import numpy as np
import pytest
import torch

from perfbench.lib import small


def test_served_tokens_agree_with_reference():
    r = small.run("dsmoe-generate")
    assert r["correct"], r["checks"]
    assert r["checks"]["served_mean_gap"]["value"] < 0.01


def test_training_agrees_with_reference():
    r = small.run("dsmoe-train", seconds=0.5)
    assert r["correct"], r["checks"]
    c = r["checks"]
    assert c["loader_batches_differing"]["value"] == 0
    assert c["loss_gap"]["value"] < 1e-5
    assert c["first_grad_gap"]["value"] < 1e-4
    assert c["change_gap"]["value"] < 1e-3


def test_altered_token_is_not_correct(monkeypatch):
    from repro_torch.serve import lm
    real = lm.ServeEngine.generate

    def broken(self, *a, **kw):
        out = real(self, *a, **kw)
        toks = out["tokens"].copy()
        toks[0, 1] = (toks[0, 1] + 1) % self.model.cfg.vocab
        return dict(out, tokens=toks)
    monkeypatch.setattr(lm.ServeEngine, "generate", broken)
    r = small.run("dsmoe-generate")
    assert not r["correct"], r["checks"]


def test_unchanged_state_is_not_correct(monkeypatch):
    """A step that returns its state unchanged (no update)."""
    from repro_torch.train import loop

    def no_update(grads, state, params, cfg):
        z = torch.zeros(())
        return {"grad_norm": z, "lr": z}
    monkeypatch.setattr(loop, "adamw_update", no_update)
    r = small.run("dsmoe-train", seconds=0.5)
    assert not r["correct"], r["checks"]
    assert r["checks"]["change_gap"]["value"] >= 0.99


def test_half_batch_is_not_correct(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from repro_torch.models import zoo
    real = zoo.Model.loss

    def half(self, batch):
        tokens = torch.as_tensor(np.asarray(batch["tokens"]))
        return real(self, {"tokens": tokens[: max(1, len(tokens) // 2)]})
    monkeypatch.setattr(zoo.Model, "loss", half)
    r = small.run("dsmoe-train", seconds=0.5)
    assert not r["correct"], r["checks"]


def test_altered_batch_is_not_correct(monkeypatch):
    """A token altered where the loader produces it."""
    from repro_torch.data import loader
    real = loader.BullionLoader.__iter__

    def altered(self):
        for batch, cursor in real(self):
            batch = batch.copy()
            batch[0, 3] += 1
            yield batch, cursor
    monkeypatch.setattr(loader.BullionLoader, "__iter__", altered)
    r = small.run("dsmoe-train", seconds=0.5)
    assert not r["correct"], r["checks"]


def test_float8_control_reads_a_wider_gap():
    """The reference at float8 in the served model's place: the tokens it
    puts first lie far further below the reference's best than the
    program's, on average."""
    from perfbench.drivers.generate import served_stats
    from perfbench.reference.moe_lm import Reference
    from perfbench.lib import models
    from repro_torch.serve import ServeEngine
    cell = small.small_cell("dsmoe-generate")
    cfg, tr = cell.config, cell.traffic
    seed = 2**31 + 99
    model = models.build(cfg, seed, "cpu", torch.bfloat16)
    from perfbench.drivers.generate import prompts
    p = prompts(cfg, tr, seed, 1)
    toks = ServeEngine(model, max_seq=tr["max_seq"], device="cpu") \
        .generate(p, tr["new_tokens"])["tokens"]
    ref = Reference(cfg, seed, "cpu", torch.bfloat16)
    ctl = Reference(cfg, seed, "cpu", torch.bfloat16, precision="fp8")
    with torch.no_grad():
        program = served_stats(ref, p, toks)
        control = served_stats(ref, p, toks, control=ctl)
    assert control["mean"] > 3 * program["mean"], (control, program)
