"""Bullion cascading encoding framework (paper §2.6, Table 2)."""

from .base import (BY_NAME, REGISTRY, CostWeights, EncodeContext, Encoding,
                   blob_encoding_name, decode_blob, mask_blob)
from .cascade import (advise_candidates, choose_encoding, encode_array,
                      encode_bytes)
from .bytes_ import decode_strings, encode_strings

__all__ = [
    "BY_NAME", "REGISTRY", "CostWeights", "EncodeContext", "Encoding",
    "advise_candidates", "blob_encoding_name", "decode_blob", "mask_blob",
    "choose_encoding", "encode_array", "encode_bytes",
    "encode_strings", "decode_strings",
]
