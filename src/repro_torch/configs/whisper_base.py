"""whisper-base [audio]: 6L enc + 6L dec, d_model=512, 8H, d_ff=2048,
vocab=51865. Enc-dec; conv/mel frontend STUBBED (precomputed frame embeds).
[arXiv:2212.04356]"""

from ..models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865,
    segments=((("full:gelu",), 6),),          # decoder depth
    encoder=EncoderConfig(n_layers=6, seq=1500, d_input=512),
    norm="layernorm", frontend="audio_stub", tie_embeddings=True,
    sub_quadratic=False,                       # full attention -> skip long_500k
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
        segments=((("full:gelu",), 2),),
        encoder=EncoderConfig(n_layers=2, seq=16, d_input=64))
