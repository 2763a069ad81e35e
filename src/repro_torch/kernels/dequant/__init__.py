from .ops import dequant
from .ref import dequant_ref, to_bf16

__all__ = ["dequant", "dequant_ref", "to_bf16"]
