"""Cascading encoding framework — base interfaces (Bullion §2.6).

Every encoded page is a self-describing binary blob:

    blob := u8 enc_id | u32 header_len | header | u64 payload_len | payload

``header`` is encoding-specific fixed metadata (widths, counts, dtypes);
``payload`` may itself contain child blobs (cascading).  Encodings register
themselves in a global registry keyed by ``eid`` so any blob decodes without
out-of-band information — the modular, composable interface the paper argues
Parquet/ORC lack.

Selection (``cascade.encode_array``) is sampling-based (BtrBlocks-style) with a
Nimble-style weighted objective over {size, encode time, decode time} and a
bounded recursion depth.

A ``bfloat16`` column (dtype code 12) reads back as its uint16 bit patterns,
the only exact NumPy form without ``ml_dtypes``; predicates see it widened
to float32 (``bf16_to_f32``); the writer takes the bits (see
``BF16_STORAGE``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

# ---------------------------------------------------------------------------
# dtype tagging
# ---------------------------------------------------------------------------

_DTYPE_CODES: dict[str, int] = {
    "int8": 0, "int16": 1, "int32": 2, "int64": 3,
    "uint8": 4, "uint16": 5, "uint32": 6, "uint64": 7,
    "float16": 8, "float32": 9, "float64": 10, "bool": 11,
    "bfloat16": 12,  # stored as uint16 payload
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}

# The writer encodes bf16 bits as ``BF16_STORAGE``, a two-byte void dtype:
# like ``ml_dtypes.bfloat16`` (kind "V") only the ``trivial`` encoding
# applies to it, and its code is 12, so pages are byte-identical to the
# reference's.
BF16_CODE = 12
BF16_STORAGE = np.dtype("V2")


def dtype_code(dt: np.dtype) -> int:
    dt = np.dtype(dt)
    if dt == BF16_STORAGE:
        return BF16_CODE
    if dt.name not in _DTYPE_CODES:
        raise TypeError(f"unsupported column dtype {dt.name}")
    return _DTYPE_CODES[dt.name]


def code_dtype(code: int) -> np.dtype:
    """The NumPy dtype a page of dtype ``code`` decodes to; bfloat16 (12)
    decodes to its uint16 bit patterns."""
    if code == BF16_CODE:
        return np.dtype(np.uint16)
    return np.dtype(_CODE_DTYPES[code])


def code_name(code: int) -> str:
    """The column dtype name of ``code`` as a ``ColumnSpec`` takes it
    (``"bfloat16"`` for 12)."""
    return _CODE_DTYPES[code]


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32 values, exact."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def is_bf16_blob(blob: bytes | memoryview) -> bool:
    """Does a scalar page blob hold bfloat16 values? (Only the trivial
    encoding applies to them, so its header's dtype code says.)"""
    eid, header, _, _ = unframe(blob)
    return REGISTRY[eid].name == "trivial" and header[0] == BF16_CODE


# ---------------------------------------------------------------------------
# blob framing
# ---------------------------------------------------------------------------

_FRAME = struct.Struct("<BIQ")  # eid, header_len, payload_len


def frame(eid: int, header: bytes, payload: bytes) -> bytes:
    return _FRAME.pack(eid, len(header), len(payload)) + header + payload


def unframe(blob: bytes | memoryview, offset: int = 0) -> tuple[int, memoryview, memoryview, int]:
    """Return (eid, header, payload, end_offset)."""
    mv = memoryview(blob)
    eid, hlen, plen = _FRAME.unpack_from(mv, offset)
    ho = offset + _FRAME.size
    po = ho + hlen
    end = po + plen
    return eid, mv[ho:po], mv[po:end], end


# ---------------------------------------------------------------------------
# encode context / cost model
# ---------------------------------------------------------------------------


@dataclass
class CostWeights:
    """Nimble-style linear objective: minimize w_size*bytes + w_enc*t + w_dec*t."""

    size: float = 1.0
    encode_time: float = 0.0
    decode_time: float = 0.0


@dataclass
class EncodeContext:
    max_depth: int = 2
    depth: int = 0
    weights: CostWeights = field(default_factory=CostWeights)
    sample_size: int = 1024
    # restrict candidate encodings by name (None = registry order)
    candidates: Optional[tuple[str, ...]] = None
    rng: np.random.Generator = field(default_factory=lambda: np.random.default_rng(0))

    def child(self) -> "EncodeContext":
        return EncodeContext(
            max_depth=self.max_depth,
            depth=self.depth + 1,
            weights=self.weights,
            sample_size=self.sample_size,
            candidates=None,  # children pick freely
            rng=self.rng,
        )


# ---------------------------------------------------------------------------
# encoding base + registry
# ---------------------------------------------------------------------------


class Encoding:
    """One entry of the encoding catalog (Table 2)."""

    eid: int = -1
    name: str = "abstract"

    # -- selection -----------------------------------------------------------
    def applicable(self, arr: np.ndarray, ctx: EncodeContext) -> bool:
        raise NotImplementedError

    # -- codec ----------------------------------------------------------------
    def encode(self, arr: np.ndarray, ctx: EncodeContext) -> Optional[bytes]:
        """Return a full framed blob, or None if this array can't profit."""
        raise NotImplementedError

    def decode(self, header: memoryview, payload: memoryview) -> np.ndarray:
        raise NotImplementedError

    # -- deletion compliance (Bullion §2.1) ------------------------------------
    # Mask element at `positions` *in place* in the encoded representation.
    # MUST return a blob of exactly the same length (the paper's size
    # criterion) or raise Unsupported to signal the caller to fall back to a
    # deletion-vector-only strategy for this page.
    def mask(self, header: memoryview, payload: memoryview, positions: np.ndarray,
             n_values: int) -> Optional[tuple[bytes, bytes]]:
        return None  # default: no in-place masking; DV-only


REGISTRY: dict[int, Encoding] = {}
BY_NAME: dict[str, Encoding] = {}


def register(enc: Encoding) -> Encoding:
    if enc.eid in REGISTRY:
        raise ValueError(f"duplicate eid {enc.eid} ({enc.name} vs {REGISTRY[enc.eid].name})")
    REGISTRY[enc.eid] = enc
    BY_NAME[enc.name] = enc
    return enc


def decode_blob(blob: bytes | memoryview) -> np.ndarray:
    eid, header, payload, _ = unframe(blob)
    return REGISTRY[eid].decode(header, payload)


def blob_encoding_name(blob: bytes | memoryview) -> str:
    eid, _, _, _ = unframe(blob)
    return REGISTRY[eid].name


def mask_blob(blob: bytes | memoryview, positions: np.ndarray, n_values: int) -> Optional[bytes]:
    """In-place masking of deleted positions. Returns a same-length blob or
    None when only deletion-vector deletes are possible.

    Encodings with a native masking rule (§2.1: bit-packed, varint, RLE,
    dictionary, FOR) use it; for the rest we attempt the generic
    decode -> zero -> re-encode path, accepted only when the result still
    fits the original page (the paper's size criterion). zstd'd or
    mostly-constant pages usually shrink when rows zero out, so physical
    erasure succeeds for most of the catalog."""
    eid, header, payload, _ = unframe(blob)
    enc = REGISTRY[eid]
    positions = np.asarray(positions, np.int64)
    out = enc.mask(header, payload, positions, n_values)
    if out is not None:
        new_header, new_payload = out
        new_blob = frame(eid, new_header, new_payload)
    else:
        try:
            arr = enc.decode(header, payload)
        except Exception:
            return None
        if len(arr) != n_values:
            return None  # already compacted by an earlier delete
        arr = arr.copy()
        arr[positions] = 0  # physical erasure
        try:
            new_blob = enc.encode(arr, EncodeContext())
        except Exception:
            new_blob = None
        if new_blob is None or len(new_blob) > len(memoryview(blob)):
            return None
    if len(new_blob) > len(memoryview(blob)):
        raise AssertionError(
            f"{enc.name}.mask violated the size criterion: "
            f"{len(new_blob)} > {len(memoryview(blob))}")
    # pad to identical size so page offsets in the file never move
    return new_blob + b"\x00" * (len(memoryview(blob)) - len(new_blob))
