"""rwkv6-7b [ssm]: 32L, d_model=4096, attention-free (WKV6 data-dependent
decay), d_ff=14336, vocab=65536. [arXiv:2404.05892] head_size=64 -> 64 heads."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536,
    segments=((("rwkv:none",), 32),),
    norm="layernorm",
    sub_quadratic=True,                        # O(1) state decode
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
        segments=((("rwkv:none",), 2),))
