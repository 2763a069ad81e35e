"""Byte-string column encodings: FSST-lite + raw/zstd binary.

A string/binary column is physically (offsets:int64[n+1], data:uint8[...]).
`encode_strings` cascades the offsets like any integer column and picks
between FSST-lite and chunked-zstd for the data bytes.

``zstandard`` is an optional dependency: when missing, ``RawBytes`` falls
back to stdlib ``zlib`` on the write path. The codec is recorded in the blob
header, so files written with either codec decode wherever that codec exists.
"""

from __future__ import annotations

import struct
import zlib
from collections import Counter

import numpy as np

try:
    import zstandard as zstd
except ImportError:  # pragma: no cover - environment-dependent
    zstd = None

from .base import EncodeContext, frame, register, unframe, Encoding
from .numeric import _cat, _split2


class FsstLite(Encoding):
    """Static greedy symbol table: up to 254 frequent 2-8 byte substrings are
    replaced by single codes; 0xFF escapes literal bytes >= 0xF0."""

    eid, name = 15, "fsst_lite"
    ESCAPE = 0xFF
    MAX_SYMBOLS = 254

    def applicable(self, arr, ctx):
        return isinstance(arr, (bytes, bytearray, memoryview))

    def _train(self, sample: bytes) -> list[bytes]:
        counts: Counter = Counter()
        for w in (2, 3, 4, 6, 8):
            for i in range(0, max(len(sample) - w, 0), w):
                counts[sample[i:i + w]] += 1
        scored = sorted(counts.items(), key=lambda kv: -(len(kv[0]) - 1) * kv[1])
        return [s for s, c in scored[: self.MAX_SYMBOLS] if c > 2 and len(s) > 1]

    def encode(self, data: bytes, ctx: EncodeContext):
        data = bytes(data)
        table = self._train(data[: 1 << 16])
        if not table:
            return None
        out = bytearray()
        # longest-match greedy with a first-byte index
        first: dict[int, list[tuple[bytes, int]]] = {}
        for idx, sym in enumerate(table):
            first.setdefault(sym[0], []).append((sym, idx))
        for k in first:
            first[k].sort(key=lambda t: -len(t[0]))
        i, n = 0, len(data)
        while i < n:
            b = data[i]
            hit = None
            for sym, idx in first.get(b, ()):
                if data.startswith(sym, i):
                    hit = (sym, idx)
                    break
            if hit:
                out.append(hit[1])
                i += len(hit[0])
            else:
                # literal bytes colliding with symbol codes or escape range
                if b < len(table) or b >= 0xF0:
                    out.append(self.ESCAPE)
                out.append(b)
                i += 1
        if len(out) >= n:
            return None
        tbl = b"".join(struct.pack("<B", len(s)) + s for s in table)
        header = struct.pack("<QQH", n, len(out), len(table)) + tbl
        return frame(self.eid, header, bytes(out))

    def decode(self, header, payload) -> np.ndarray:
        n, enc_len, nsym = struct.unpack_from("<QQH", header)
        off = 18
        table: list[bytes] = []
        hb = bytes(header)
        for _ in range(nsym):
            ln = hb[off]
            table.append(hb[off + 1: off + 1 + ln])
            off += 1 + ln
        data = bytes(payload)
        out = bytearray()
        i = 0
        while i < len(data):
            c = data[i]
            if c == self.ESCAPE:
                out.append(data[i + 1])
                i += 2
            elif c < len(table):
                out += table[c]
                i += 1
            else:
                out.append(c)
                i += 1
        return np.frombuffer(bytes(out), np.uint8, count=n)


class RawBytes(Encoding):
    """bytes payload, compressed when profitable.

    Codec byte in the header: 0 = stored, 1 = zstd, 2 = zlib. zstd is used
    when the optional ``zstandard`` module is importable; otherwise the write
    path degrades to zlib and zstd-coded blobs raise a clear error on read.
    """

    eid, name = 16, "raw_bytes"
    STORED, ZSTD, ZLIB = 0, 1, 2

    def applicable(self, arr, ctx):
        return isinstance(arr, (bytes, bytearray, memoryview))

    def encode(self, data: bytes, ctx: EncodeContext):
        data = bytes(data)
        if zstd is not None:
            comp, codec = zstd.ZstdCompressor(level=3).compress(data), self.ZSTD
        else:
            comp, codec = zlib.compress(data, 6), self.ZLIB
        use, codec = (comp, codec) if len(comp) < len(data) else (data, self.STORED)
        header = struct.pack("<QB", len(data), codec)
        return frame(self.eid, header, use)

    def decode(self, header, payload) -> np.ndarray:
        n, codec = struct.unpack_from("<QB", header)
        if codec == self.ZSTD:
            if zstd is None:
                raise RuntimeError(
                    "blob is zstd-compressed but the optional 'zstandard' "
                    "module is not installed")
            raw = zstd.ZstdDecompressor().decompress(bytes(payload),
                                                     max_output_size=max(n, 1))
        elif codec == self.ZLIB:
            raw = zlib.decompress(bytes(payload))
        else:
            raw = bytes(payload)
        return np.frombuffer(raw, np.uint8, count=n)


for _enc in (FsstLite(), RawBytes()):
    register(_enc)


# ---------------------------------------------------------------------------
# string column = offsets + data, encoded together
# ---------------------------------------------------------------------------

STRING_MAGIC = 0xBC


def encode_strings(strings: list[bytes], ctx: EncodeContext | None = None) -> bytes:
    from .cascade import encode_array, encode_bytes
    ctx = ctx or EncodeContext()
    lens = np.asarray([len(s) for s in strings], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    data = b"".join(strings)
    off_blob = encode_array(offsets, ctx.child())
    data_blob = encode_bytes(data, ctx.child())
    return struct.pack("<BQ", STRING_MAGIC, len(strings)) + _cat(off_blob, data_blob)


def decode_strings(blob: bytes | memoryview) -> list[bytes]:
    from .base import decode_blob
    mv = memoryview(blob)
    magic, n = struct.unpack_from("<BQ", mv)
    assert magic == STRING_MAGIC
    off_blob, data_blob = _split2(mv[9:])
    offsets = decode_blob(off_blob).astype(np.int64)
    data = decode_blob(data_blob).tobytes()
    return [data[offsets[i]:offsets[i + 1]] for i in range(n)]
