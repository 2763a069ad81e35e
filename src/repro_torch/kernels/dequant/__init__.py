from .ops import dequant, dequant_columns, dequant_packed
from .ref import dequant_packed_ref, dequant_ref, to_bf16
from .staging import layout_columns, pack_columns

__all__ = ["dequant", "dequant_columns", "dequant_packed", "dequant_packed_ref",
           "dequant_ref", "layout_columns", "pack_columns", "to_bf16"]
