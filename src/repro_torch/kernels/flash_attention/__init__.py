from .ops import attention, flash_attention
from .ref import attention_bwd_ref, attention_ref

__all__ = ["attention", "attention_bwd_ref", "attention_ref", "flash_attention"]
