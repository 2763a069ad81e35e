"""Multimodal storage (Bullion §2.5, Fig. 7).

Dual-table architecture:
  * **meta table** — Bullion columnar file: text, quality scores, embeddings,
    *inlined critical frames* (reduced-resolution), and media_ref keys.
  * **media table** — row-oriented binary chunk store (the paper's Avro role)
    holding full-size media blobs, looked up only when full resolution is
    actually needed.

Write path presorts rows by quality score (descending) so quality-filtered
training reads the file as one sequential prefix instead of scattered rows.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .quantization import QuantMode, QuantSpec
from .writer import BullionWriter, ColumnSpec, quality_sort

_REC = struct.Struct("<QQ")  # key, size
_MEDIA_MAGIC = b"BULMEDIA"


class MediaStore:
    """Append-only row-oriented blob store with a trailing key index."""

    def __init__(self, path: str):
        self.path = path

    def write(self, blobs: dict[int, bytes]) -> None:
        index: list[tuple[int, int, int]] = []
        with open(self.path, "wb") as f:
            for key, blob in blobs.items():
                index.append((key, f.tell(), len(blob)))
                f.write(_REC.pack(key, len(blob)))
                f.write(blob)
            idx_off = f.tell()
            for key, off, size in index:
                f.write(struct.pack("<QQQ", key, off, size))
            f.write(struct.pack("<QI", idx_off, len(index)) + _MEDIA_MAGIC)

    def _index(self) -> dict[int, tuple[int, int]]:
        with open(self.path, "rb") as f:
            f.seek(-20, 2)
            idx_off, n = struct.unpack("<QI", f.read(12))
            assert f.read(8) == _MEDIA_MAGIC
            f.seek(idx_off)
            out = {}
            for _ in range(n):
                key, off, size = struct.unpack("<QQQ", f.read(24))
                out[key] = (off, size)
        return out

    def read(self, keys: Sequence[int]) -> dict[int, bytes]:
        """Random-access lookups (the slow path the meta table avoids)."""
        idx = self._index()
        out = {}
        with open(self.path, "rb") as f:
            for k in keys:
                off, size = idx[k]
                f.seek(off + _REC.size)
                out[k] = f.read(size)
        return out


@dataclass
class MultimodalSample:
    text: bytes
    quality: float
    embedding: np.ndarray          # float32[d]
    frames: bytes                  # reduced-res critical frames, inlined
    media_key: int                 # full-size video in the media table


def write_multimodal_dataset(meta_path: str, media_path: str,
                             samples: list[MultimodalSample],
                             rows_per_group: int = 4096,
                             embed_quant: Optional[QuantSpec] = None) -> dict:
    """Write the §2.5 layout: quality-presorted meta table + media table."""
    schema = [
        ColumnSpec("text", "string"),
        ColumnSpec("quality", "float32"),
        ColumnSpec("embedding", "list<float32>"),
        ColumnSpec("frames", "string"),
        ColumnSpec("media_key", "media_ref"),
    ]
    if embed_quant is None:
        embed_quant = QuantSpec(QuantMode.NONE)
    writer = BullionWriter(meta_path, schema, rows_per_group=rows_per_group,
                           sort_udf=quality_sort("quality"),
                           props={"layout": "multimodal-v1"})
    writer.write_table({
        "text": [s.text for s in samples],
        "quality": np.asarray([s.quality for s in samples], np.float32),
        "embedding": [s.embedding.astype(np.float32) for s in samples],
        "frames": [s.frames for s in samples],
        "media_key": np.asarray([s.media_key for s in samples], np.uint64),
    })
    stats = writer.close()
    MediaStore(media_path).write({s.media_key: s.frames * 8 for s in samples})
    return stats


def quality_filtered_read(meta_path: str, columns: Sequence[str],
                          top_fraction: float, *,
                          device=None) -> tuple[list[dict], "IOStats"]:
    """Read the top-`top_fraction` quality rows. Because rows were presorted
    by quality at write time, the ``head`` plan touches only a *prefix* of
    row groups — the limit is pushed into physical planning, so trailing
    groups are accounted as pruned bytes and never pread. ``device`` is
    where the read's dequantize runs (default ``cuda``; raises where CUDA
    is absent unless given ``"cpu"``)."""
    from ..dataset import dataset

    with dataset(meta_path, device=device) as ds:
        n_take = int(ds.num_rows * top_fraction)
        out = list(ds.select(list(columns)).head(n_take).to_batches())
        if not out:
            # n_take == 0: keep the legacy shape (one table of typed empty
            # columns) so callers can concatenate unconditionally
            out = [ds.select(list(columns)).head(0).to_table()]
        stats = ds.stats
    return out, stats
