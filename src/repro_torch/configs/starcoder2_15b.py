"""starcoder2-15b [dense]: 40L, d_model=6144, 48H (GQA kv=4), d_ff=24576,
vocab=49152, RoPE, LayerNorm + GELU MLP. [arXiv:2402.19173]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab=49152,
    segments=((("full:gelu",), 40),),
    norm="layernorm",
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        segments=((("full:gelu",), 2),))
