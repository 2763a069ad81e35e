"""Model configuration schema for the architecture zoo (framework-free).

A model is a sequence of *segments*; each segment is a repeating *pattern* of
blocks. A block is "attn_kind:mlp_kind", e.g. "full:swiglu", "window:moe",
"rglru:swiglu", "rwkv:rwkv". This is the port's own copy of
``repro.models.config``; the two must declare the same fields.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (frontend stubbed to precomputed frames)."""
    n_layers: int = 6
    seq: int = 1500          # mel frames after conv stub
    d_input: int = 512       # frame embedding dim (== d_model for whisper)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    segments: tuple[tuple[tuple[str, ...], int], ...]  # ((blocks...), repeat)

    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope_theta: float = 10000.0
    qk_norm: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma-style sqrt(d) embedding scaling
    window: int = 4096               # sliding-window size for "window"/"local"
    logit_softcap: float = 0.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_ff: int = 0
    n_shared: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    # MLA
    mla: Optional[MLAConfig] = None

    # RWKV / RG-LRU
    lru_width: int = 0
    conv_width: int = 4
    rwkv_chunked: bool = False

    # encoder-decoder
    encoder: Optional[EncoderConfig] = None

    frontend: str = "none"           # none | audio_stub | vlm_stub
    sub_quadratic: bool = False      # supports long_500k decode
    compute_dtype: str = "bfloat16"

    # performance knobs of the reference (kept so configs stay field-equal)
    cast_params_once: bool = False
    remat_policy: str = "full"       # full | dots
    fused_qkv: bool = False          # one fused in-projection per block

    @property
    def n_layers(self) -> int:
        return sum(len(blocks) * rep for blocks, rep in self.segments)

    def scaled(self, **overrides) -> "ModelConfig":
        """Derive a reduced config (smoke tests)."""
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
