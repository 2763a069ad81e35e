from .ops import bitunpack, pack_bp32
from .ref import bitunpack_ref, pack_bp32_ref

__all__ = ["bitunpack", "pack_bp32", "bitunpack_ref", "pack_bp32_ref"]
