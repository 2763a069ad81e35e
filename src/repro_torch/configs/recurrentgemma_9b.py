"""recurrentgemma-9b [hybrid]: 38 blocks in a (RG-LRU, RG-LRU, local-attn)
pattern (1 attention : 2 recurrent) + 2 trailing recurrent blocks; d_model=4096,
16H (MQA kv=1, head_dim=256), d_ff=12288, vocab=256000, window=2048.
[arXiv:2402.19427]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    segments=(
        (("rglru:swiglu", "rglru:swiglu", "local:swiglu"), 12),
        (("rglru:swiglu",), 2),
    ),
    window=2048, lru_width=4096, conv_width=4, embed_scale=True,
    tie_embeddings=True,
    sub_quadratic=True,    # recurrent state + bounded local window
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(
        d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab=256,
        window=8, lru_width=64,
        segments=((("rglru:swiglu", "rglru:swiglu", "local:swiglu"), 1),
                  (("rglru:swiglu",), 1)))
