"""Plain PyTorch version of the decode-attention kernel.

One query token [B, 1, H, D] over a layer's cache k, v [B, S, Hkv, D] at
the step's position ``pos``: the n = min(pos + 1, S) slots 0 .. n - 1 are
the valid ones (a full cache's slots 0 .. pos; a rolling buffer's slots
written so far, all S once it has wrapped), the others masked. It is the
model's plain decode attention, ``dot_attention`` over the cache cast to
q's dtype, so that on the CPU it equals
``models.transformer.decode_attention`` bit for bit: k and v rounded to q's
dtype, the scores in f32 over sqrt(D), the softmax in f32, the
probabilities rounded to v's dtype, the product with v in that dtype.
"""

from __future__ import annotations

import torch

from ...models.layers import dot_attention


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos) -> torch.Tensor:
    """q [B, 1, H, D], k, v [B, S, Hkv, D], ``pos`` an int or a 0-d tensor
    -> [B, 1, H, D] in q's dtype."""
    S = k.shape[1]
    slots = torch.arange(S, device=q.device)
    valid = (slots <= pos)[None, :].expand(q.shape[0], S)
    return dot_attention(q, k.to(q.dtype), v.to(q.dtype), slots[:1], slots,
                         causal=False, kv_valid=valid)
