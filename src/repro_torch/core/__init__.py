"""Bullion core: the paper's columnar storage system (primary contribution).

Submodules: encodings (§2.6 cascading framework), footer/reader (§2.3 wide
table projection), writer/multimodal (§2.5 quality-aware organization),
deletion/merkle (§2.1 compliance), quantization (§2.4), sparse_delta (§2.2),
backend (storage backends: local pread / object-store ranged GETs behind
``bullion://`` URIs / the async batched range fetcher).
"""

from .backend import (ObjectStoreBackend, RetryPolicy, StorageBackend,
                      configure_object_store, open_shard, register_backend)

from .deletion import (Compliance, DeleteStats, delete_rows, delete_where,
                       verify_deleted)
from .encodings import (CostWeights, EncodeContext, choose_encoding,
                        decode_blob, encode_array, mask_blob)
from .footer import ColKind, FooterView, PageType, Sec, read_footer
from .merkle import MerkleTree, page_hash
from .multimodal import (MediaStore, MultimodalSample, quality_filtered_read,
                         write_multimodal_dataset)
from .quantization import (QuantMode, QuantSpec, affine_spec_for, dequantize,
                           quantize, rejoin_dual_fp16, suggest_spec)
from .reader import BullionReader
from .writer import BullionWriter, ColumnSpec, quality_sort

__all__ = [
    "BullionReader", "BullionWriter", "ColumnSpec", "ColKind", "Compliance",
    "ObjectStoreBackend", "RetryPolicy", "StorageBackend",
    "configure_object_store", "open_shard", "register_backend",
    "CostWeights", "DeleteStats", "EncodeContext", "FooterView", "MediaStore",
    "MerkleTree", "MultimodalSample", "PageType", "QuantMode", "QuantSpec",
    "Sec", "affine_spec_for", "choose_encoding", "decode_blob", "delete_rows",
    "delete_where", "dequantize", "encode_array", "mask_blob", "page_hash",
    "quality_sort",
    "quality_filtered_read", "quantize", "read_footer", "rejoin_dual_fp16",
    "suggest_spec", "verify_deleted", "write_multimodal_dataset",
]
