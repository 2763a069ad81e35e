"""deepseek-moe-16b [moe]: 28L, d_model=2048, 16H (MHA kv=16), vocab=102400.
Layer 0 is dense (d_ff=10944); layers 1..27 are fine-grained MoE with 64
routed experts (d_ff=1408, top-6) + 2 shared experts. [arXiv:2401.06066]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab=102400,
    segments=((("full:swiglu",), 1), (("full:moe",), 27)),
    n_experts=64, top_k=6, moe_ff=1408, n_shared=2,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
        n_experts=8, top_k=2, moe_ff=32, n_shared=1,
        segments=((("full:swiglu",), 1), (("full:moe",), 2)))
