"""Per-chunk / per-page bloom value sketches for unclustered point probes.

Zone maps only prune where the write path clustered: an unclustered id
column has min==global-min, max==global-max in every chunk, so a point
probe ``C("id") == k`` degenerates to a full scan. A small write-time bloom
filter over each chunk's (and each page's) distinct values answers the one
question zone maps can't: *could this value possibly be here?* A refuted
chunk is skipped without any data pread; inside a surviving chunk, refuted
page ordinals drop one page per read column, exactly like page zone maps.

Soundness contract (false positives allowed, false negatives **never**):

- Both the write side and the probe side canonicalize values through
  ``canonical_u64`` — the float64 bit pattern of the value, with ``+ 0.0``
  applied so ``-0.0`` and ``0.0`` (which compare equal) share one key.
- NaNs are excluded at write time: ``== NaN`` matches no row under IEEE
  comparison, so their absence can never cause a false negative.
- Quantized columns sketch the *dequantized* (logical) domain, the same
  domain zone maps describe and predicates are written against.
- L2 deletes mask rows to zero in place; ``core.deletion`` inserts the key
  for 0 into every touched sketch, mirroring ``stats.widen_to_zero``.

Wire format — one self-describing blob per sketch, referenced by u64
offsets from ``Sec.CHUNK_SKETCH`` / ``Sec.PAGE_SKETCH`` into
``Sec.SKETCH_DATA`` (offset ``u64max`` = no sketch, prune nothing):

    [u32 nbits][u16 n_hash][u16 reserved][nbits/8 filter bytes]

``nbits`` is a power of two so the double-hash positions reduce with a
mask; the header makes each blob's size self-evident, so no size array is
needed alongside the offsets.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

# ~8 bits/key with 4 hashes gives a ~2.4% false-positive rate — one wasted
# group read per ~40 refutable probes, against zero data reads saved by
# zone maps on unclustered columns.
BITS_PER_KEY = 8
N_HASH = 4
MIN_BITS = 64                 # floor so tiny pages still get a real filter
MAX_BITS = 1 << 20            # 128 KiB cap per sketch; skip above (no prune)
NO_SKETCH = np.uint64(0xFFFFFFFFFFFFFFFF)

_HEADER = struct.Struct("<IHH")
HEADER_SIZE = _HEADER.size

_U64 = np.uint64
# splitmix64 constants; numpy uint64 arithmetic wraps silently, which is
# exactly the mod-2^64 behaviour the mixer wants
_C1 = _U64(0xBF58476D1CE4E5B9)
_C2 = _U64(0x94D049BB133111EB)
_GOLDEN = _U64(0x9E3779B97F4A7C15)


def canonical_u64(values) -> np.ndarray:
    """Map values to their canonical u64 sketch keys (float64 bit pattern).

    Adding ``0.0`` first folds ``-0.0`` onto ``+0.0`` so equal-comparing
    values share a key. NaNs are the caller's problem: exclude them on the
    write side (``== NaN`` never matches), and never probe with them.
    Integers above 2^53 may collide after the float64 round-trip — that
    only *adds* keys a probe can hit, so it costs false positives, never
    false negatives, as long as the probe side rounds the same way."""
    f = np.asarray(values).astype(np.float64, copy=True)
    f += 0.0
    return f.view(np.uint64)


def _mix(h: np.ndarray) -> np.ndarray:
    h = (h ^ (h >> _U64(30))) * _C1
    h = (h ^ (h >> _U64(27))) * _C2
    return h ^ (h >> _U64(31))


def _positions(keys: np.ndarray, nbits: int, n_hash: int) -> np.ndarray:
    """Bit positions for each key: double hashing h1 + i*h2 (mod nbits).
    Returns shape (n_hash, len(keys)) of int64 positions."""
    h1 = _mix(keys.astype(_U64, copy=False))
    h2 = _mix(h1 + _GOLDEN) | _U64(1)
    mask = _U64(nbits - 1)
    out = np.empty((n_hash, len(h1)), np.int64)
    h = h1
    for i in range(n_hash):
        out[i] = (h & mask).astype(np.int64)
        h = h + h2
    return out


def _pow2_bits(n_keys: int) -> int:
    target = max(MIN_BITS, n_keys * BITS_PER_KEY)
    return 1 << int(target - 1).bit_length()


class BloomSketch:
    """A fixed-size bloom filter over canonical u64 keys.

    ``bits`` is a uint8 array of nbits/8 bytes (little-endian bit order
    within each byte, matching ``np.packbits(bitorder='little')``)."""

    __slots__ = ("nbits", "n_hash", "bits")

    def __init__(self, nbits: int, n_hash: int, bits: np.ndarray):
        self.nbits = int(nbits)
        self.n_hash = int(n_hash)
        self.bits = bits

    # -- construction ---------------------------------------------------------
    @classmethod
    def build(cls, keys: np.ndarray) -> Optional["BloomSketch"]:
        """Build from canonical u64 keys (pre-deduplicated or not). Returns
        None when the sized filter would blow the ``MAX_BITS`` cap — absent
        sketch means "prune nothing", which is always sound."""
        keys = np.asarray(keys, _U64)
        nbits = _pow2_bits(len(keys))
        if nbits > MAX_BITS:
            return None
        sk = cls(nbits, N_HASH, np.zeros(nbits // 8, np.uint8))
        if len(keys):
            sk.insert(keys)
        return sk

    def insert(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, _U64)
        if not len(keys):
            return
        pos = _positions(keys, self.nbits, self.n_hash).ravel()
        np.bitwise_or.at(self.bits, pos >> 3,
                         np.uint8(1) << (pos & 7).astype(np.uint8))

    # -- probing --------------------------------------------------------------
    def may_contain(self, value) -> bool:
        """True unless the filter *proves* the value absent. The probe value
        is canonicalized here, so callers pass raw predicate literals."""
        key = canonical_u64([value])
        pos = _positions(key, self.nbits, self.n_hash).ravel()
        hit = self.bits[pos >> 3] & (np.uint8(1) << (pos & 7).astype(np.uint8))
        return bool((hit != 0).all())

    # -- serialization --------------------------------------------------------
    def to_bytes(self) -> bytes:
        return _HEADER.pack(self.nbits, self.n_hash, 0) + self.bits.tobytes()

    @property
    def nbytes(self) -> int:
        return HEADER_SIZE + len(self.bits)

    @classmethod
    def from_buffer(cls, buf, offset: int = 0) -> "BloomSketch":
        """View a sketch inside a larger buffer (e.g. ``Sec.SKETCH_DATA``)
        without copying the filter bytes. The returned ``bits`` view is
        read-only when the buffer is; call sites that must mutate (deletion
        widening) copy first."""
        nbits, n_hash, _ = _HEADER.unpack_from(buf, offset)
        bits = np.frombuffer(buf, np.uint8, count=nbits // 8,
                             offset=offset + HEADER_SIZE)
        return cls(nbits, n_hash, bits)
