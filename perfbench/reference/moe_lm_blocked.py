"""The plain reference of ``perfbench/reference/moe_lm.py`` with attention
computed one batch row at a time, so that its scores fit at a long prompt:
at 32 rows, 48 heads and 2,175 positions the whole batch's f32 scores are
29 GB a copy, one row's 0.91 GB. Everything else is ``moe_lm.Reference``'s
(float32, no kernels, no cache, one layer's weights at a time; the MoE
routes each call under its own capacity). The float8 control scales each
row's operands by that row's largest magnitude.

It imports nothing of the program; the weights come from
``perfbench/gen/weights.py``.
"""

from __future__ import annotations

import torch

from perfbench.reference import moe_lm


class Reference(moe_lm.Reference):
    def attention(self, w, x, pos):
        return torch.cat([super(Reference, self).attention(w, x[b:b + 1], pos)
                          for b in range(x.shape[0])])
