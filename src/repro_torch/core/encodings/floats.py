"""Floating-point encodings (Bullion Table 2: Gorilla/Chimp, Pseudodecimal/ALP).

``XorFloat`` is a vectorized Chimp-flavored variant: XOR against the previous
value's bit pattern, then cascade-encode the XOR stream as integers (runs of
zeros / few set bits compress well downstream).  ``AlpDecimal`` is ALP-lite:
losslessly rescale decimals to integers when possible and cascade those.
"""

from __future__ import annotations

import struct

import numpy as np

from .base import EncodeContext, Encoding, code_dtype, dtype_code, frame, register
from .numeric import _cat, _split2


def _uint_view(arr: np.ndarray) -> tuple[np.ndarray, np.dtype]:
    if arr.dtype == np.float64:
        return arr.view(np.uint64), np.dtype(np.uint64)
    if arr.dtype == np.float32:
        return arr.view(np.uint32), np.dtype(np.uint32)
    if arr.dtype == np.float16:
        return arr.view(np.uint16), np.dtype(np.uint16)
    raise TypeError(arr.dtype)


class XorFloat(Encoding):
    eid, name = 13, "xor_float"

    def applicable(self, arr, ctx):
        return arr.dtype.kind == "f" and len(arr) > 1

    def encode(self, arr, ctx):
        from .cascade import encode_array
        u, udt = _uint_view(np.ascontiguousarray(arr))
        x = u.copy()
        x[1:] = u[1:] ^ u[:-1]
        child = encode_array(x, ctx.child())
        header = struct.pack("<BQ", dtype_code(arr.dtype), len(arr))
        return frame(self.eid, header, child)

    def decode(self, header, payload):
        from .base import decode_blob
        code, n = struct.unpack_from("<BQ", header)
        dt = code_dtype(code)
        x = decode_blob(payload)
        u = np.bitwise_xor.accumulate(x)
        return u.view(dt).copy()


class AlpDecimal(Encoding):
    """ALP-lite: x == round(x * 10^e) / 10^e exactly -> encode ints."""

    eid, name = 14, "alp_decimal"
    MAX_E = {4: 7, 8: 15}

    def applicable(self, arr, ctx):
        return arr.dtype.kind == "f" and arr.dtype.itemsize >= 4 and len(arr) > 0

    def _find_exponent(self, arr):
        finite = np.isfinite(arr)
        if not finite.all():
            return None
        for e in range(0, self.MAX_E[arr.dtype.itemsize] + 1):
            scale = 10.0 ** e
            scaled = arr.astype(np.float64) * scale
            if np.abs(scaled).max(initial=0.0) > 2**52:
                return None
            ints = np.round(scaled)
            if np.array_equal(ints / scale, arr.astype(np.float64)):
                return e, ints.astype(np.int64)
        return None

    def encode(self, arr, ctx):
        from .cascade import encode_array
        found = self._find_exponent(arr)
        if found is None:
            return None
        e, ints = found
        child = encode_array(ints, ctx.child())
        header = struct.pack("<BQB", dtype_code(arr.dtype), len(arr), e)
        return frame(self.eid, header, child)

    def decode(self, header, payload):
        from .base import decode_blob
        code, n, e = struct.unpack_from("<BQB", header)
        ints = decode_blob(payload)
        return (ints.astype(np.float64) / 10.0 ** e).astype(code_dtype(code))


for _enc in (XorFloat(), AlpDecimal()):
    register(_enc)
