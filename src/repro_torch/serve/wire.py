"""Wire protocol for the dataset service: framing + JSON codecs.

Messages are length-prefixed JSON over a stream socket: a little-endian u32
byte count followed by the UTF-8 payload. Binary column data rides inside
the JSON as base64 (the service targets local AF_UNIX round trips, where
simplicity beats zero-copy; the in-process ``DatasetServer`` API skips this
layer entirely).

Predicates serialize structurally (one dict node per AST node), so a client
builds them with the normal ``C`` combinators and the server rehydrates an
identical tree — including the equality leaves the bloom sketches refute.
"""

from __future__ import annotations

import base64
import json
import socket
import struct
from typing import Optional

import numpy as np

from ..scan.predicate import And, Cmp, In, Not, Or, Predicate

_LEN = struct.Struct("<I")
MAX_MESSAGE = 1 << 30


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    if len(data) > MAX_MESSAGE:
        # refuse to emit a frame the peer is contractually bound to reject
        # (and that would wrap the u32 length prefix past 4 GiB)
        raise ValueError(f"frame of {len(data)} bytes exceeds {MAX_MESSAGE}")
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    parts = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            return None                 # peer closed mid-frame (or EOF at 0)
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def recv_msg(sock: socket.socket) -> Optional[dict]:
    """One framed message, or None on orderly EOF.

    Error contract (what the server's session loop and its query log key
    off): ``ValueError`` for an unparseable frame — oversized length
    prefix, or a body that is not valid JSON (``json.JSONDecodeError`` is
    a ``ValueError``) — and ``ConnectionError`` for a peer that vanished
    mid-frame. Both are session-fatal: the frame boundary is gone, so the
    caller must drop the connection (never the process)."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_MESSAGE:
        raise ValueError(f"frame of {n} bytes exceeds {MAX_MESSAGE}")
    body = _recv_exact(sock, n)
    if body is None:
        raise ConnectionError("peer closed mid-frame")
    msg = json.loads(body.decode())
    if not isinstance(msg, dict):
        raise ValueError(f"frame payload must be a JSON object, "
                         f"got {type(msg).__name__}")
    return msg


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------

def _scalar(v):
    """JSON-able python scalar from a predicate literal."""
    if isinstance(v, (np.generic,)):
        return v.item()
    return v


def encode_predicate(pred: Optional[Predicate]) -> Optional[dict]:
    if pred is None:
        return None
    if isinstance(pred, Cmp):
        return {"t": "cmp", "col": pred.col, "op": pred.op,
                "v": _scalar(pred.value)}
    if isinstance(pred, In):
        return {"t": "in", "col": pred.col,
                "v": [_scalar(v) for v in pred.values]}
    if isinstance(pred, And):
        return {"t": "and", "c": [encode_predicate(c) for c in pred.children]}
    if isinstance(pred, Or):
        return {"t": "or", "c": [encode_predicate(c) for c in pred.children]}
    if isinstance(pred, Not):
        return {"t": "not", "c": encode_predicate(pred.child)}
    raise TypeError(f"cannot serialize predicate node {type(pred).__name__}")


def decode_predicate(obj: Optional[dict]) -> Optional[Predicate]:
    if obj is None:
        return None
    t = obj["t"]
    if t == "cmp":
        return Cmp(obj["col"], obj["op"], obj["v"])
    if t == "in":
        return In(obj["col"], obj["v"])
    if t == "and":
        return And(*[decode_predicate(c) for c in obj["c"]])
    if t == "or":
        return Or(*[decode_predicate(c) for c in obj["c"]])
    if t == "not":
        return Not(decode_predicate(obj["c"]))
    raise ValueError(f"unknown predicate node type {t!r}")


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

def _b64(b) -> str:
    return base64.b64encode(bytes(b)).decode("ascii")


def _unb64(s: str) -> bytes:
    return base64.b64decode(s.encode("ascii"))


def encode_table(table: dict) -> dict:
    """Dataset result table -> JSON-able dict. Scalar columns are one
    base64 buffer; list columns one buffer per row; string columns base64
    the raw bytes per row."""
    out: dict = {}
    for name, col in table.items():
        if isinstance(col, np.ndarray):
            out[name] = {"kind": "array", "dtype": col.dtype.name,
                         "b64": _b64(np.ascontiguousarray(col).tobytes())}
        elif isinstance(col, list):
            if col and isinstance(col[0], np.ndarray):
                out[name] = {"kind": "list", "dtype": col[0].dtype.name,
                             "rows": [_b64(np.ascontiguousarray(r).tobytes())
                                      for r in col]}
            else:
                # bytes rows (string/media columns) — or an empty column,
                # which decodes to an empty list either way
                out[name] = {"kind": "bytes",
                             "rows": [_b64(r) for r in col]}
        else:
            raise TypeError(f"column {name!r}: cannot serialize "
                            f"{type(col).__name__}")
    return out


def decode_table(enc: dict) -> dict:
    out: dict = {}
    for name, col in enc.items():
        kind = col["kind"]
        if kind == "array":
            out[name] = np.frombuffer(_unb64(col["b64"]),
                                      dtype=np.dtype(col["dtype"]))
        elif kind == "list":
            dt = np.dtype(col["dtype"])
            out[name] = [np.frombuffer(_unb64(r), dtype=dt)
                         for r in col["rows"]]
        elif kind == "bytes":
            out[name] = [_unb64(r) for r in col["rows"]]
        else:
            raise ValueError(f"unknown column kind {kind!r}")
    return out
