"""minicpm3-4b [dense]: 62L, d_model=2560, 40H (MHA kv=40), d_ff=6400,
vocab=73448, Multi-head Latent Attention (MLA). [hf:openbmb/MiniCPM3-4B]"""

from ..models.config import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=6400, vocab=73448,
    segments=((("mla:swiglu",), 62),),
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    sub_quadratic=False,   # full attention (MLA compresses the cache, but the
                           # family is quadratic-prefill -> long_500k skipped)
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
        segments=((("mla:swiglu",), 2),),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16))
