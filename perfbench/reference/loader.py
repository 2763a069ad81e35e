"""Plain NumPy reference of the training loader's stream: the documents
whose quality passes the threshold, in the corpus's stored order (quality
descending, ties in generation order), their tokens concatenated, epoch
after epoch, cut into batches of ``B x (S + 1)``. It imports nothing of
the program."""

from __future__ import annotations

import numpy as np


def batches(docs: dict, min_quality: float, batch: int, seq: int,
            first: int, count: int) -> list:
    """Batches ``first .. first + count - 1`` of the stream, int32."""
    order = np.argsort(-docs["quality"], kind="stable")
    keep = [docs["tokens"][i] for i in order
            if docs["quality"][i] >= np.float32(min_quality)]
    epoch = np.concatenate(keep).astype(np.int32)
    n = batch * (seq + 1)
    lo, hi = first * n, (first + count) * n
    reps = -(-hi // len(epoch))
    stream = np.tile(epoch, reps) if reps > 1 else epoch
    return [stream[lo + i * n: lo + (i + 1) * n].reshape(batch, seq + 1)
            for i in range(count)]
