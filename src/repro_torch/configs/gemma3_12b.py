"""gemma3-12b [dense]: 48L, d_model=3840, 16H (GQA kv=8, head_dim=256),
d_ff=15360, vocab=262144, 5:1 local(1k window):global interleave, qk-norm,
sqrt(d) embed scaling, tied embeddings. [hf:google/gemma-3-*]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144,
    segments=(((("local:swiglu",) * 5 + ("global:swiglu",)), 8),),
    window=1024, qk_norm=True, embed_scale=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
    sub_quadratic=True,   # 5/6 layers are 1k-window; long_500k decode runs
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        window=8,
        segments=(((("local:swiglu",) * 2 + ("global:swiglu",)), 2),))
