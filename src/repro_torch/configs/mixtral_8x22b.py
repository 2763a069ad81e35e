"""mixtral-8x22b [moe]: 56L, d_model=6144, 48H (GQA kv=8), expert d_ff=16384,
vocab=32768, 8 experts top-2, sliding-window attention. [arXiv:2401.04088]

``window=4096`` and the ``window:moe`` blocks match the JAX package's
config field for field, which the parity tests hold the port to. The
published model has no sliding window (arXiv:2401.04088 section 2 gives it
a fully dense context; its config's ``sliding_window`` is null), and the
benchmark's ``mixtral-8x22b-stage`` (``perfbench/configs/``) runs full
attention, as published."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768,
    segments=((("window:moe",), 56),),
    window=4096,
    n_experts=8, top_k=2, moe_ff=16384,
    sub_quadratic=True,    # SWA rolling KV -> bounded decode cache
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        window=8, n_experts=4, top_k=2, moe_ff=64,
        segments=((("window:moe",), 2),))
