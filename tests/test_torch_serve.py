"""The port's serving engine on the CPU against the JAX package's."""

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import zoo as jzoo
from repro.serve import ServeEngine as JaxServeEngine
import repro_torch.configs as tconfigs
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import load_jax_params
from repro_torch.serve import ServeEngine


@pytest.fixture(scope="module")
def engines():
    jcfg = jconfigs.get_smoke("llama3_2_1b").scaled(compute_dtype="float32")
    jm = jzoo.build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = tzoo.build(tconfigs.get_smoke("llama3_2_1b").scaled(
        compute_dtype="float32"), device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return (JaxServeEngine(jm, params, max_seq=64),
            ServeEngine(tm, max_seq=64, device="cpu"))


@pytest.mark.parametrize("B,P,new,seed", [(3, 16, 8, 1), (2, 5, 12, 2)])
def test_generate_matches_jax_engine(engines, B, P, new, seed):
    jeng, teng = engines
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (B, P),
                                            0, 256), np.int32)
    ref = jeng.generate(prompts, max_new_tokens=new)
    out = teng.generate(prompts, max_new_tokens=new)
    assert set(out) == set(ref)
    assert out["tokens"].dtype == np.int32 and out["tokens"].shape == (B, new)
    assert np.array_equal(out["tokens"], ref["tokens"])
    assert out["decode_tok_per_s"] > 0 and out["prefill_s"] > 0
    again = teng.generate(prompts, max_new_tokens=new)    # greedy: deterministic
    assert np.array_equal(again["tokens"], out["tokens"])


def test_generate_past_max_seq_raises(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="full"):
        teng.generate(np.zeros((1, 60), np.int32), max_new_tokens=8)


def test_frames_not_ported(engines):
    _, teng = engines
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        teng.generate(np.zeros((1, 4), np.int32), 2,
                      frames=np.zeros((1, 8, 4), np.float32))


def test_engine_device_must_match_model(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="engine asked"):
        ServeEngine(teng.model, max_seq=8, device="meta")


def test_generate_bf16_compute_on_cpu():
    """The serving path at bf16 compute (the card's type) runs end to end."""
    cfg = tconfigs.get_smoke("llama3.2-1b")
    eng = ServeEngine(tzoo.build(cfg, device="cpu", dtype=torch.bfloat16),
                      max_seq=32, device="cpu")
    out = eng.generate(np.arange(16, dtype=np.int32).reshape(2, 8), 6)
    assert out["tokens"].shape == (2, 6)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab)).all()
