"""Integer / boolean encodings of the Bullion catalog (Table 2).

All codecs are vectorized numpy. Each supports the framework's `mask` hook
where the paper defines an in-place deletion-masking rule (§2.1):

  FixedBitWidth  -> zero the element's bits                  (in-place)
  Varint/LEB128  -> keep continuation MSBs, zero 7-bit groups (in-place)
  RLE            -> compact-delete + deletion vector          (shrinks, padded)
  Dictionary     -> rewrite code to the reserved mask entry   (in-place)
  FOR            -> zero the offset bits (delegates to child) (in-place)
  everything else-> deletion-vector only (mask() returns None)
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

try:
    import zstandard as zstd
except ImportError:  # pragma: no cover - environment-dependent
    zstd = None

from .base import (EncodeContext, Encoding, code_dtype, dtype_code, frame,
                   register, unframe)

# ---------------------------------------------------------------------------
# bit packing helpers
# ---------------------------------------------------------------------------


def pack_bits(vals: np.ndarray, width: int) -> bytes:
    """Pack unsigned values into a little-endian bitstream of `width` bits each."""
    n = len(vals)
    if width == 0 or n == 0:
        return b""
    v = vals.astype(np.uint64, copy=False)
    shifts = np.arange(width, dtype=np.uint64)
    bits = ((v[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def unpack_bits(buf: memoryview | bytes, n: int, width: int) -> np.ndarray:
    if width == 0 or n == 0:
        return np.zeros(n, np.uint64)
    raw = np.frombuffer(buf, np.uint8, count=(n * width + 7) // 8)
    bits = np.unpackbits(raw, count=n * width, bitorder="little").reshape(n, width)
    shifts = np.arange(width, dtype=np.uint64)
    return (bits.astype(np.uint64) << shifts).sum(axis=1, dtype=np.uint64)


def bit_width(max_val: int) -> int:
    return int(max_val).bit_length()


# ---------------------------------------------------------------------------
# LEB128 helpers
# ---------------------------------------------------------------------------


def leb128_encode(u: np.ndarray) -> tuple[bytes, np.ndarray]:
    """Vectorized LEB128. Returns (bytes, per-value byte counts)."""
    u = u.astype(np.uint64, copy=False)
    nbytes = np.ones(len(u), np.int64)
    for k in range(1, 10):
        nbytes += (u >= (np.uint64(1) << np.uint64(7 * k))).astype(np.int64)
    total = int(nbytes.sum())
    out = np.zeros(total, np.uint8)
    starts = np.concatenate([[0], np.cumsum(nbytes)[:-1]])
    for k in range(10):
        sel = nbytes > k
        if not sel.any():
            break
        idx = starts[sel] + k
        group = ((u[sel] >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(np.uint8)
        cont = (nbytes[sel] - 1 > k).astype(np.uint8) << 7
        out[idx] = group | cont
    return out.tobytes(), nbytes


def leb128_boundaries(buf: np.ndarray) -> np.ndarray:
    """Start offset of each encoded value (appends total length)."""
    ends = (buf & 0x80) == 0
    starts = np.flatnonzero(np.concatenate([[True], ends[:-1]]))
    return np.concatenate([starts, [len(buf)]])


def leb128_decode(buf: memoryview | bytes, n: int) -> np.ndarray:
    b = np.frombuffer(buf, np.uint8)
    if len(b) == 0:
        if n:
            raise ValueError(f"empty varint stream, expected {n} values")
        return np.zeros(0, np.uint64)
    ends = (b & 0x80) == 0
    group = np.concatenate([[0], np.cumsum(ends)[:-1]]).astype(np.int64)
    group_starts = np.flatnonzero(np.concatenate([[True], ends[:-1]]))
    pos = np.arange(len(b), dtype=np.int64) - group_starts[group]
    contrib = (b & 0x7F).astype(np.uint64) << (np.uint64(7) * pos.astype(np.uint64))
    out = np.zeros(int(ends.sum()), np.uint64)
    np.add.at(out, group, contrib)
    if len(out) != n:
        raise ValueError(f"varint stream holds {len(out)} values, expected {n}")
    return out


# ---------------------------------------------------------------------------
# zigzag
# ---------------------------------------------------------------------------


def zigzag_encode(x: np.ndarray) -> np.ndarray:
    x64 = x.astype(np.int64, copy=False)
    return ((x64.astype(np.uint64) << np.uint64(1)) ^ (x64 >> np.int64(63)).astype(np.uint64))


def zigzag_decode(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint64, copy=False)
    return ((u >> np.uint64(1)).astype(np.int64) ^ -(u & np.uint64(1)).astype(np.int64))


def _is_int(arr: np.ndarray) -> bool:
    return arr.dtype.kind in "iu"


def _to_u64_lossless(arr: np.ndarray) -> np.ndarray:
    """Reinterpret any integer array as uint64 via zigzag for signed."""
    if arr.dtype.kind == "u":
        return arr.astype(np.uint64)
    return zigzag_encode(arr)


def _from_u64(u: np.ndarray, dt: np.dtype) -> np.ndarray:
    if np.dtype(dt).kind == "u":
        return u.astype(dt)
    return zigzag_decode(u).astype(dt)


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------


class Trivial(Encoding):
    eid, name = 1, "trivial"

    def applicable(self, arr, ctx):
        return True

    def encode(self, arr, ctx):
        header = struct.pack("<BQ", dtype_code(arr.dtype), len(arr))
        return frame(self.eid, header, np.ascontiguousarray(arr).tobytes())

    def decode(self, header, payload):
        code, n = struct.unpack_from("<BQ", header)
        return np.frombuffer(payload, code_dtype(code), count=n).copy()

    def mask(self, header, payload, positions, n_values):
        code, n = struct.unpack_from("<BQ", header)
        arr = np.frombuffer(payload, code_dtype(code), count=n).copy()
        arr[positions] = 0  # physically erase
        return bytes(header), arr.tobytes()


class FixedBitWidth(Encoding):
    """Bit-pack non-negative integers at a fixed minimal width."""

    eid, name = 2, "fixed_bit_width"

    def applicable(self, arr, ctx):
        return _is_int(arr) and len(arr) > 0 and (arr.dtype.kind == "u" or arr.min() >= 0)

    def encode(self, arr, ctx):
        u = arr.astype(np.uint64)
        width = bit_width(int(u.max())) if len(u) else 0
        header = struct.pack("<BQB", dtype_code(arr.dtype), len(arr), width)
        return frame(self.eid, header, pack_bits(u, width))

    def decode(self, header, payload):
        code, n, width = struct.unpack_from("<BQB", header)
        return unpack_bits(payload, n, width).astype(code_dtype(code))

    def mask(self, header, payload, positions, n_values):
        code, n, width = struct.unpack_from("<BQB", header)
        if width == 0:
            return bytes(header), bytes(payload)
        u = unpack_bits(payload, n, width)
        u[positions] = 0  # zero the element's bits
        return bytes(header), pack_bits(u, width)


class Varint(Encoding):
    """LEB128; signed inputs are zigzagged first (flag in header)."""

    eid, name = 3, "varint"

    def applicable(self, arr, ctx):
        return _is_int(arr)

    def encode(self, arr, ctx):
        u = _to_u64_lossless(arr)
        data, _ = leb128_encode(u)
        header = struct.pack("<BQ", dtype_code(arr.dtype), len(arr))
        return frame(self.eid, header, data)

    def decode(self, header, payload):
        code, n = struct.unpack_from("<BQ", header)
        return _from_u64(leb128_decode(payload, n), code_dtype(code))

    def mask(self, header, payload, positions, n_values):
        code, n = struct.unpack_from("<BQ", header)
        b = np.frombuffer(payload, np.uint8).copy()
        bounds = leb128_boundaries(b)
        for p in positions:  # zero 7-bit groups, preserve continuation MSBs
            s, e = bounds[p], bounds[p + 1]
            b[s:e] &= 0x80
        return bytes(header), b.tobytes()


class RLE(Encoding):
    """values + run-lengths as two child-encoded subcolumns."""

    eid, name = 4, "rle"

    def applicable(self, arr, ctx):
        return _is_int(arr) or arr.dtype.kind in "fb"

    @staticmethod
    def _runs(arr):
        n = len(arr)
        bounds = np.flatnonzero(np.concatenate([[True], arr[1:] != arr[:-1]]))
        values = arr[bounds]
        lengths = np.diff(np.concatenate([bounds, [n]]))
        return values, lengths

    def encode(self, arr, ctx):
        from .cascade import encode_array
        if len(arr) == 0:
            return None
        values, lengths = self._runs(arr)
        if len(values) > len(arr) // 2:
            return None  # not profitable
        vblob = encode_array(values, ctx.child())
        lblob = encode_array(lengths.astype(np.uint32), ctx.child())
        header = struct.pack("<BQQ", dtype_code(arr.dtype), len(arr), len(values))
        return frame(self.eid, header, _cat(vblob, lblob))

    def decode(self, header, payload):
        from .base import decode_blob
        code, n, nruns = struct.unpack_from("<BQQ", header)
        vblob, lblob = _split2(payload)
        values = decode_blob(vblob)
        lengths = decode_blob(lblob)
        return np.repeat(values, lengths.astype(np.int64)).astype(code_dtype(code))

    def mask(self, header, payload, positions, n_values):
        # compact delete: drop deleted elements, re-encode; deletion vector
        # (kept at page level) restores alignment. Never grows (runs merge).
        code, n, _ = struct.unpack_from("<BQQ", header)
        full = self.decode(header, payload)
        keep = np.ones(len(full), bool)
        keep[positions] = False
        remaining = full[keep]
        blob = self.encode(remaining, EncodeContext()) or Trivial().encode(remaining, EncodeContext())
        eid, h2, p2, _ = unframe(blob)
        if eid != self.eid:
            return None  # re-encode fell back to another encoding
        if len(h2) + len(p2) > len(header) + len(payload):
            # child-encoding choices changed; cannot honor the size criterion
            return None
        return bytes(h2), bytes(p2)


class Dictionary(Encoding):
    """Dictionary with a reserved mask entry (code == n_unique) for deletion."""

    eid, name = 5, "dictionary"

    def applicable(self, arr, ctx):
        return len(arr) > 0 and arr.dtype.kind in "iuf"

    def encode(self, arr, ctx):
        from .cascade import encode_array
        values, codes = np.unique(arr, return_inverse=True)
        if len(values) > max(16, len(arr) // 4):
            return None
        width = bit_width(len(values))  # reserve mask entry == len(values)
        vblob = encode_array(values, ctx.child())
        header = struct.pack("<BQQB", dtype_code(arr.dtype), len(arr), len(values), width)
        return frame(self.eid, header, _cat(vblob, pack_bits(codes.astype(np.uint64), width)))

    def decode(self, header, payload):
        from .base import decode_blob
        code, n, nuniq, width = struct.unpack_from("<BQQB", header)
        vblob, packed = _split2(payload)
        values = decode_blob(vblob)
        codes = unpack_bits(packed, n, width).astype(np.int64)
        # mask entries decode to a neutral 0 (NOT values[0] — decoding a real
        # value would make erasure audits see phantom occurrences); the page
        # DV drops these rows anyway
        masked = codes >= nuniq
        out = values[np.where(masked, 0, codes)]
        out[masked] = 0
        return out.astype(code_dtype(code))

    def mask(self, header, payload, positions, n_values):
        code, n, nuniq, width = struct.unpack_from("<BQQB", header)
        vblob, packed = _split2(payload)
        codes = unpack_bits(packed, n, width)
        codes[positions] = nuniq  # the reserved mask entry
        return bytes(header), _cat(bytes(vblob), pack_bits(codes, width))


class FOR(Encoding):
    """Frame-of-reference: min base + bit-packed offsets (random access)."""

    eid, name = 6, "for"

    def applicable(self, arr, ctx):
        return _is_int(arr) and len(arr) > 0

    def encode(self, arr, ctx):
        lo = int(arr.min())
        offsets = (arr.astype(np.int64) - lo).astype(np.uint64)
        width = bit_width(int(offsets.max())) if len(offsets) else 0
        header = struct.pack("<BQqB", dtype_code(arr.dtype), len(arr), lo, width)
        return frame(self.eid, header, pack_bits(offsets, width))

    def decode(self, header, payload):
        code, n, lo, width = struct.unpack_from("<BQqB", header)
        return (unpack_bits(payload, n, width).astype(np.int64) + lo).astype(code_dtype(code))

    def mask(self, header, payload, positions, n_values):
        code, n, lo, width = struct.unpack_from("<BQqB", header)
        if width == 0:
            return bytes(header), bytes(payload)
        u = unpack_bits(payload, n, width)
        u[positions] = 0  # decodes to base; page DV hides it
        return bytes(header), pack_bits(u, width)


class Constant(Encoding):
    eid, name = 7, "constant"

    def applicable(self, arr, ctx):
        return len(arr) > 0 and arr.dtype.kind in "iufb"

    def encode(self, arr, ctx):
        if len(arr) == 0 or not (arr == arr[0]).all():
            return None
        header = struct.pack("<BQ", dtype_code(arr.dtype), len(arr))
        return frame(self.eid, header, arr[:1].tobytes())

    def decode(self, header, payload):
        code, n = struct.unpack_from("<BQ", header)
        v = np.frombuffer(payload, code_dtype(code), count=1)
        return np.full(n, v[0], code_dtype(code))

    def mask(self, header, payload, positions, n_values):
        return bytes(header), bytes(payload)  # DV hides; nothing identifying stored


class MainlyConstant(Encoding):
    """Frequency encoding: constant + exception positions + exception values."""

    eid, name = 8, "mainly_constant"

    def applicable(self, arr, ctx):
        return len(arr) > 0 and arr.dtype.kind in "iuf"

    def encode(self, arr, ctx):
        from .cascade import encode_array
        values, counts = np.unique(arr, return_counts=True)
        top = values[np.argmax(counts)]
        exc = np.flatnonzero(arr != top)
        if len(exc) > len(arr) // 8:
            return None
        pos_blob = encode_array(exc.astype(np.uint32), ctx.child())
        val_blob = encode_array(arr[exc], ctx.child()) if len(exc) else b""
        header = struct.pack("<BQQ", dtype_code(arr.dtype), len(arr), len(exc)) + \
            np.asarray([top], arr.dtype).tobytes()
        return frame(self.eid, header, _cat(pos_blob, val_blob))

    def decode(self, header, payload):
        from .base import decode_blob
        code, n, nexc = struct.unpack_from("<BQQ", header)
        dt = code_dtype(code)
        top = np.frombuffer(header[17:17 + dt.itemsize], dt)[0]
        out = np.full(n, top, dt)
        if nexc:
            pos_blob, val_blob = _split2(payload)
            out[decode_blob(pos_blob).astype(np.int64)] = decode_blob(val_blob)
        return out


class SparseBool(Encoding):
    """Roaring-flavored booleans: bitmap, or position list for sparse sides."""

    eid, name = 9, "sparse_bool"

    def applicable(self, arr, ctx):
        return arr.dtype.kind == "b"

    def encode(self, arr, ctx):
        n = len(arr)
        ones = np.flatnonzero(arr)
        mode = 0  # bitmap
        if n >= 64:
            if len(ones) * 32 < n:
                mode = 1  # sparse ones as u32 positions
            elif (n - len(ones)) * 32 < n:
                mode = 2  # sparse zeros
        if mode == 0:
            payload = np.packbits(arr.astype(np.uint8), bitorder="little").tobytes()
        else:
            pos = ones if mode == 1 else np.flatnonzero(~arr)
            payload, _ = leb128_encode(pos.astype(np.uint64))
            payload = struct.pack("<Q", len(pos)) + payload
        header = struct.pack("<QB", n, mode)
        return frame(self.eid, header, payload)

    def decode(self, header, payload):
        n, mode = struct.unpack_from("<QB", header)
        if mode == 0:
            raw = np.frombuffer(payload, np.uint8)
            return np.unpackbits(raw, count=n, bitorder="little").astype(bool)
        (npos,) = struct.unpack_from("<Q", payload)
        pos = leb128_decode(payload[8:], npos).astype(np.int64)
        out = np.zeros(n, bool) if mode == 1 else np.ones(n, bool)
        out[pos] = mode == 1
        return out


class Huffman(Encoding):
    """Canonical Huffman for small-alphabet integers."""

    eid, name = 10, "huffman"
    MAX_ALPHABET = 1024

    def applicable(self, arr, ctx):
        return _is_int(arr) and 0 < len(arr)

    def encode(self, arr, ctx):
        import heapq
        values, inverse, counts = np.unique(arr, return_inverse=True, return_counts=True)
        if len(values) > self.MAX_ALPHABET or len(values) < 2:
            return None
        # build code lengths
        lens = np.zeros(len(values), np.int64)
        heap = [(int(c), i, [i]) for i, c in enumerate(counts)]
        heapq.heapify(heap)
        next_idx = len(values)
        while len(heap) > 1:
            c1, _, m1 = heapq.heappop(heap)
            c2, _, m2 = heapq.heappop(heap)
            for s in m1 + m2:
                lens[s] += 1
            heapq.heappush(heap, (c1 + c2, next_idx, m1 + m2))
            next_idx += 1
        # canonical codes (shorter first, then symbol order)
        order = np.lexsort((np.arange(len(values)), lens))
        codes = np.zeros(len(values), np.uint64)
        code, prev_len = 0, 0
        for sym in order:
            code <<= (lens[sym] - prev_len)
            codes[sym] = code
            code += 1
            prev_len = lens[sym]
        elens = lens[inverse]
        starts = np.concatenate([[0], np.cumsum(elens)[:-1]])
        total_bits = int(elens.sum())
        bits = np.zeros(total_bits, np.uint8)
        ecodes = codes[inverse]
        for k in range(int(lens.max())):
            sel = elens > k
            if not sel.any():
                break
            idx = starts[sel] + k
            bits[idx] = ((ecodes[sel] >> (elens[sel] - 1 - k).astype(np.uint64)) & np.uint64(1)).astype(np.uint8)
        payload = np.packbits(bits, bitorder="little").tobytes()
        from .cascade import encode_array
        vblob = encode_array(values, ctx.child())
        lens_blob = pack_bits(lens.astype(np.uint64), 6)
        header = struct.pack("<BQQQ", dtype_code(arr.dtype), len(arr), len(values), total_bits)
        return frame(self.eid, header, _cat(vblob, _cat(lens_blob, payload)))

    def decode(self, header, payload):
        from .base import decode_blob
        code, n, nsym, total_bits = struct.unpack_from("<BQQQ", header)
        vblob, rest = _split2(payload)
        lens_blob, bitstream = _split2(rest)
        values = decode_blob(vblob)
        lens = unpack_bits(lens_blob, nsym, 6).astype(np.int64)
        order = np.lexsort((np.arange(nsym), lens))
        codes = np.zeros(nsym, np.uint64)
        code_acc, prev_len = 0, 0
        for sym in order:
            code_acc <<= (lens[sym] - prev_len)
            codes[sym] = code_acc
            code_acc += 1
            prev_len = lens[sym]
        # decode table keyed by (len, code)
        table = {(int(lens[s]), int(codes[s])): s for s in range(nsym)}
        bits = np.unpackbits(np.frombuffer(bitstream, np.uint8), count=total_bits,
                             bitorder="little")
        out = np.empty(n, np.int64)
        acc, alen, oi = 0, 0, 0
        maxlen = int(lens.max())
        for b in bits:
            acc = (acc << 1) | int(b)
            alen += 1
            sym = table.get((alen, acc))
            if sym is not None:
                out[oi] = sym
                oi += 1
                acc, alen = 0, 0
            elif alen > maxlen:
                raise ValueError("corrupt huffman stream")
        return values[out].astype(code_dtype(code))


class BitShuffle(Encoding):
    """Transpose element-bits so same-significance bits are contiguous, then
    child-encode the shuffled bytes (typically Chunked/zstd)."""

    eid, name = 11, "bitshuffle"

    def applicable(self, arr, ctx):
        return arr.dtype.kind in "iuf" and len(arr) >= 64

    def encode(self, arr, ctx):
        from .cascade import encode_array
        a = np.ascontiguousarray(arr)
        itemsize = a.dtype.itemsize
        raw = a.view(np.uint8).reshape(len(a), itemsize)
        bits = np.unpackbits(raw, axis=1, bitorder="little")
        shuffled = np.packbits(bits.T.reshape(-1), bitorder="little")
        child = encode_array(shuffled, ctx.child())
        header = struct.pack("<BQ", dtype_code(arr.dtype), len(arr))
        return frame(self.eid, header, child)

    def decode(self, header, payload):
        from .base import decode_blob
        code, n = struct.unpack_from("<BQ", header)
        dt = code_dtype(code)
        shuffled = decode_blob(payload)
        nbits = n * dt.itemsize * 8
        bits = np.unpackbits(shuffled, count=nbits, bitorder="little")
        bits = bits.reshape(dt.itemsize * 8, n).T
        raw = np.packbits(bits.reshape(-1), bitorder="little")
        return np.frombuffer(raw.tobytes(), dt, count=n).copy()


class Chunked(Encoding):
    """zstd over fixed-size chunks (256 KiB) of raw bytes (general-purpose
    block compression — the paper argues it stays valuable for ML data)."""

    eid, name = 12, "chunked"
    CHUNK = 256 * 1024

    def applicable(self, arr, ctx):
        return zstd is not None and arr.dtype.kind in "iufb"

    def encode(self, arr, ctx):
        raw = np.ascontiguousarray(arr).tobytes()
        cctx = zstd.ZstdCompressor(level=3)
        chunks = [cctx.compress(raw[i:i + self.CHUNK]) for i in range(0, max(len(raw), 1), self.CHUNK)]
        sizes = np.asarray([len(c) for c in chunks], np.uint32)
        header = struct.pack("<BQI", dtype_code(arr.dtype), len(arr), len(chunks)) + sizes.tobytes()
        return frame(self.eid, header, b"".join(chunks))

    def decode(self, header, payload):
        if zstd is None:
            raise RuntimeError(
                "blob is zstd-compressed but the optional 'zstandard' "
                "module is not installed")
        code, n, nchunks = struct.unpack_from("<BQI", header)
        sizes = np.frombuffer(header[13:13 + 4 * nchunks], np.uint32)
        dctx = zstd.ZstdDecompressor()
        out, off = [], 0
        for s in sizes:
            out.append(dctx.decompress(bytes(payload[off:off + s]),
                                       max_output_size=self.CHUNK * 4))
            off += int(s)
        return np.frombuffer(b"".join(out), code_dtype(code), count=n).copy()


# ---------------------------------------------------------------------------
# child-blob catenation helpers (u64 length prefixes)
# ---------------------------------------------------------------------------


def _cat(a: bytes, b: bytes) -> bytes:
    return struct.pack("<Q", len(a)) + a + b


def _split2(payload: memoryview | bytes) -> tuple[memoryview, memoryview]:
    mv = memoryview(payload)
    (la,) = struct.unpack_from("<Q", mv)
    return mv[8:8 + la], mv[8 + la:]


for _enc in (Trivial(), FixedBitWidth(), Varint(), RLE(), Dictionary(), FOR(),
             Constant(), MainlyConstant(), SparseBool(), Huffman(), BitShuffle(),
             Chunked()):
    register(_enc)
