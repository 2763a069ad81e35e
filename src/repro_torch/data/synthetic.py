"""Deterministic synthetic corpora written as Bullion tables.

``write_lm_corpus`` emits documents with Zipfian unigrams + injected n-gram
motifs, so a language model trained on it shows a real learning curve.
``write_ads_table`` reproduces the paper's Table 1 regime: a wide table of
sparse list<int64> features with sliding-window click sequences, quality
scores, and quantized float features. ``write_quant_table`` (the port's own)
stores one float feature in each quantization mode of §2.4 but the dual-FP16
pair: INT8/UINT8/INT16 affine, BF16, FP8 E4M3 and FP16.
"""

from __future__ import annotations

import os

import numpy as np

from ..core import (BullionWriter, ColumnSpec, QuantMode, QuantSpec,
                    affine_spec_for, quality_sort)
from ..core.sparse_delta import SyntheticClickSeq


def _zipf_docs(rng, n_docs, vocab, doc_len, n_motifs=64, motif_len=8):
    """Documents with shared motifs: predictable structure for the LM."""
    motifs = rng.integers(2, vocab, (n_motifs, motif_len)).astype(np.int32)
    docs = []
    for _ in range(n_docs):
        base = (rng.zipf(1.3, doc_len).astype(np.int64) % (vocab - 2)) + 2
        base = base.astype(np.int32)
        # overwrite random spans with motifs (the learnable signal)
        for _ in range(doc_len // (motif_len * 4)):
            m = motifs[rng.integers(0, n_motifs)]
            pos = int(rng.integers(0, doc_len - motif_len))
            base[pos:pos + motif_len] = m
        docs.append(base)
    return docs


def write_lm_corpus(path: str, *, n_docs: int = 512, vocab: int = 256,
                    doc_len: int = 1024, seed: int = 0,
                    rows_per_group: int = 64) -> dict:
    rng = np.random.default_rng(seed)
    docs = _zipf_docs(rng, n_docs, vocab, doc_len)
    schema = [
        ColumnSpec("doc_id", "int64"),
        ColumnSpec("tokens", "list<int32>"),
        ColumnSpec("quality", "float32"),
        ColumnSpec("n_tokens", "int32"),
    ]
    w = BullionWriter(path, schema, rows_per_group=rows_per_group,
                      sort_udf=quality_sort("quality"),
                      props={"kind": "lm-corpus", "vocab": str(vocab)})
    w.write_table({
        "doc_id": np.arange(n_docs, dtype=np.int64),
        "tokens": docs,
        "quality": rng.random(n_docs).astype(np.float32),
        "n_tokens": np.full(n_docs, doc_len, np.int32),
    })
    return w.close()


def write_ads_table(path: str, *, n_rows: int = 8192, n_sparse: int = 32,
                    n_dense: int = 16, seq_len: int = 64, seed: int = 0,
                    rows_per_group: int = 2048) -> dict:
    """Wide ads-style table (Table 1 in miniature): sparse list<int64>
    features with sliding-window structure + BF16-quantized dense features."""
    rng = np.random.default_rng(seed)
    schema = [ColumnSpec("user_id", "int64"), ColumnSpec("ts", "int64")]
    table: dict = {
        "user_id": np.sort(rng.integers(0, n_rows // 8, n_rows)).astype(np.int64),
        "ts": np.arange(n_rows, dtype=np.int64),
    }
    gen = SyntheticClickSeq(seq_len=seq_len)
    for i in range(n_sparse):
        name = f"clk_seq_{i}"
        schema.append(ColumnSpec(name, "list<int64>", sparse_delta=True))
        table[name] = gen.generate(n_rows, seed=seed * 1000 + i)
    for i in range(n_dense):
        name = f"dense_{i}"
        schema.append(ColumnSpec(name, "float32",
                                 quant=QuantSpec(QuantMode.BF16)))
        table[name] = rng.normal(size=n_rows).astype(np.float32)
    schema.append(ColumnSpec("label", "int8"))
    table["label"] = (rng.random(n_rows) < 0.03).astype(np.int8)
    w = BullionWriter(path, schema, rows_per_group=rows_per_group,
                      props={"kind": "ads-table"})
    w.write_table(table)
    return w.close()


def write_quant_table(path: str, *, n_rows: int = 8192, seed: int = 0,
                      rows_per_group: int = 2048) -> dict:
    """Float features stored in six quantization modes (§2.4), beside an
    int64 ``id``: ``q_i8`` (N(0, 1), INT8 affine), ``q_u8`` (U(0, 10),
    UINT8 affine), ``q_i16`` (lognormal, skewed, INT16 affine), each with
    ``affine_spec_for`` its whole column; ``q_bf16``, ``q_fp8`` (FP8 E4M3)
    and ``q_fp16``, N(0, 1)."""
    rng = np.random.default_rng(seed)
    table = {
        "id": np.arange(n_rows, dtype=np.int64),
        "q_i8": rng.normal(size=n_rows).astype(np.float32),
        "q_u8": rng.uniform(0.0, 10.0, n_rows).astype(np.float32),
        "q_i16": rng.lognormal(0.0, 1.0, n_rows).astype(np.float32),
        "q_bf16": rng.normal(size=n_rows).astype(np.float32),
        "q_fp8": rng.normal(size=n_rows).astype(np.float32),
        "q_fp16": rng.normal(size=n_rows).astype(np.float32),
    }
    modes = {"q_i8": QuantMode.INT8_AFFINE, "q_u8": QuantMode.UINT8_AFFINE,
             "q_i16": QuantMode.INT16_AFFINE}
    schema = [ColumnSpec("id", "int64")]
    schema += [ColumnSpec(name, "float32",
                          quant=affine_spec_for(table[name], mode))
               for name, mode in modes.items()]
    schema += [ColumnSpec(name, "float32", quant=QuantSpec(mode))
               for name, mode in (("q_bf16", QuantMode.BF16),
                                  ("q_fp8", QuantMode.FP8_E4M3),
                                  ("q_fp16", QuantMode.FP16))]
    w = BullionWriter(path, schema, rows_per_group=rows_per_group,
                      props={"kind": "quant-table"})
    w.write_table(table)
    return w.close()
