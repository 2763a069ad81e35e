"""chameleon-34b [vlm]: 48L, d_model=8192, 64H (GQA kv=8), d_ff=22016,
vocab=65536 (early fusion: VQ image tokens share the text vocab), qk-norm.
Image tokenizer frontend STUBBED: inputs are token ids. [arXiv:2405.09818]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=65536,
    segments=((("full:swiglu",), 48),),
    qk_norm=True, frontend="vlm_stub",
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        segments=((("full:swiglu",), 2),))
