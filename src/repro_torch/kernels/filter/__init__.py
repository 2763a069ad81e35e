from .ops import range_mask
from .ref import range_mask_ref

__all__ = ["range_mask", "range_mask_ref"]
