"""llama3.2-1b [dense]: 16L, d_model=2048, 32H (GQA kv=8), d_ff=8192,
vocab=128256, RoPE theta 5e5, tied embeddings. [hf:meta-llama/Llama-3.2-1B]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128256,
    segments=((("full:swiglu",), 16),),
    rope_theta=500000.0, tie_embeddings=True,
    sub_quadratic=False,                       # pure full attention
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        segments=((("full:swiglu",), 2),))
