"""A language-model corpus made from a seed and written by the program's
writer.

Rewritten from ``src/repro_torch/data/synthetic.py`` ``write_lm_corpus``
and ``_zipf_docs`` (documents of Zipfian tokens with a ``quality`` column,
the table presorted by quality as ``quality_sort`` does), frozen here at a
real vocabulary: Zipf(1) token ids (log-uniform ranks) over the whole
vocabulary, heavy-tailed document lengths, quality uniform on [0, 1).
"""

from __future__ import annotations

import numpy as np


def documents(cfg: dict, seed: int) -> dict:
    """``{"doc_id", "tokens" (a list of int32 arrays), "quality",
    "n_tokens"}`` in generation order."""
    rng = np.random.default_rng([seed, 5])
    n, V = int(cfg["docs"]), int(cfg["vocab"])
    u = rng.random(n)
    lengths = np.minimum(cfg["min_len"] + np.floor(
        cfg["len_scale"] * ((1.0 - u) ** (-1.0 / cfg["len_alpha"]) - 1.0)),
        cfg["max_len"]).astype(np.int64)
    r = rng.random(int(lengths.sum()))
    ids = (np.exp(r * np.log(V + 1.0)).astype(np.int64) - 1).clip(0, V - 1)
    tokens = np.split(ids.astype(np.int32), np.cumsum(lengths)[:-1])
    return {"doc_id": np.arange(n, dtype=np.int64), "tokens": tokens,
            "quality": rng.random(n).astype(np.float32),
            "n_tokens": lengths.astype(np.int32)}


def write(cfg: dict, docs: dict, path: str) -> dict:
    from repro_torch.core import BullionWriter, ColumnSpec, quality_sort
    schema = [ColumnSpec("doc_id", "int64"),
              ColumnSpec("tokens", "list<int32>"),
              ColumnSpec("quality", "float32"),
              ColumnSpec("n_tokens", "int32")]
    w = BullionWriter(path, schema, rows_per_group=int(cfg["rows_per_group"]),
                      sort_udf=quality_sort("quality"),
                      props={"kind": "lm-corpus", "vocab": str(cfg["vocab"])})
    w.write_table(docs)
    return w.close()
