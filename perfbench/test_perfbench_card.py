"""The model cells' controls on the card, at a size a test run can hold:
the reference one precision below the configuration's, in the program's
place, reads far wider than the program itself (float8 for the served
bf16 model; TF32 for the f32 training step, whose TF32 does nothing on a
CPU). Skips without a CUDA card. At the cells' own sizes the same
readings come from ``perfbench/controls.py``."""

import pytest

from perfbench.lib import small


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the TF32 and kernel paths run only there)")
    return torch.device("cuda")


def test_float8_control_of_generation(card):
    from perfbench.controls import generate
    out = generate(small.small_cell("dsmoe-generate"), 2**31 + 41, card)
    assert out["control"]["mean"] > 3 * out["program"]["mean"], out


def test_tf32_control_of_training(card):
    from perfbench.controls import train
    out = train(small.small_cell("dsmoe-train"), 2**31 + 43, card)
    ctl = out.pop("control")
    assert any(ctl[k] > 3 * out[k] for k in out), (out, ctl)
