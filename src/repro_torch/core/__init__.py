"""Bullion core: the paper's columnar storage system (primary contribution).

Submodules: encodings (§2.6 cascading framework), footer/reader (§2.3 wide
table projection), writer/multimodal (§2.5 quality-aware organization),
merkle (§2.1 compliance), quantization (§2.4), sparse_delta (§2.2),
backend (storage backends: local pread / object-store ranged GETs behind
``bullion://`` URIs / the async batched range fetcher).

``deletion`` and ``multimodal`` are not ported yet (ROADMAP.md §1, the next
read slice).
"""

from .backend import (ObjectStoreBackend, RetryPolicy, StorageBackend,
                      configure_object_store, open_shard, register_backend)
from .encodings import (CostWeights, EncodeContext, choose_encoding,
                        decode_blob, encode_array, mask_blob)
from .footer import ColKind, FooterView, PageType, Sec, read_footer
from .merkle import MerkleTree, page_hash
from .quantization import (QuantMode, QuantSpec, affine_spec_for, dequantize,
                           quantize, rejoin_dual_fp16, suggest_spec)
from .reader import BullionReader
from .writer import BullionWriter, ColumnSpec, quality_sort

__all__ = [
    "BullionReader", "BullionWriter", "ColumnSpec", "ColKind",
    "ObjectStoreBackend", "RetryPolicy", "StorageBackend",
    "configure_object_store", "open_shard", "register_backend",
    "CostWeights", "EncodeContext", "FooterView",
    "MerkleTree", "PageType", "QuantMode", "QuantSpec",
    "Sec", "affine_spec_for", "choose_encoding", "decode_blob",
    "dequantize", "encode_array", "mask_blob", "page_hash",
    "quality_sort", "quantize", "read_footer", "rejoin_dual_fp16",
    "suggest_spec",
]
