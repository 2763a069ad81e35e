"""Batched serving engine, ported from ``repro.serve.lm``: prefill once,
then decode greedily. A sharded model (``build(cfg, dist=...)``) serves
through the same entry: its caches are DTensors, and logits that come
back sharded (over the vocab) are gathered whole before the argmax."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from .. import resolve_device
from ..obs import trace as _trace


def _greedy(logits) -> torch.Tensor:
    """The argmax token [B, 1] of logits [B, V], gathered whole first where
    they are a DTensor."""
    if isinstance(logits, DTensor):
        logits = logits.full_tensor()
    return logits.argmax(dim=-1)[:, None]


@dataclass
class ServeEngine:
    model: object
    max_seq: int
    device: object = None   # default cuda; must be the model's device

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.model.device.type != self.device.type:
            raise ValueError(f"model on {self.model.device}, engine asked "
                             f"for {self.device}")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 frames: Optional[np.ndarray] = None) -> dict:
        """prompts: int32[B, P], all of one length; ``frames``: the
        encoder-decoder's frame embeddings [B, S_enc, d] (copied to the
        device with the prompts, before the prefill's clock starts). Returns the
        greedy continuation int32[B, max_new_tokens] and the phases' wall
        times."""
        B, _ = prompts.shape
        # a sharded model runs under no_grad: DTensor under inference_mode
        # takes a view of a sharded dim on its local size (the head split
        # of a projection sharded over 'model' raises in torch 2.13)
        sharded = getattr(self.model, "dist", None) is not None
        with torch.no_grad() if sharded else torch.inference_mode():
            cache = self.model.init_cache(B, self.max_seq, dtype=torch.float32)
            batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int64),
                                               device=self.device)}
            if frames is not None:
                batch["frames"] = torch.as_tensor(np.asarray(frames),
                                                  device=self.device)
            self._sync()
            t0 = time.perf_counter()
            logits, cache = self.model.prefill(batch, cache)
            self._sync()
            t_prefill = time.perf_counter() - t0

            # generated tokens stay on the device; one copy to the host at the end
            out = torch.empty((B, max_new_tokens), dtype=torch.int64,
                              device=self.device)
            tok = _greedy(logits)
            with _trace.span("serve.decode", cat="serve",
                             steps=max_new_tokens, batch=B):
                t0 = time.perf_counter()
                for i in range(max_new_tokens):
                    out[:, i] = tok[:, 0]
                    logits, cache = self.model.decode_step(cache, tok)
                    tok = _greedy(logits)
                self._sync()
                t_decode = time.perf_counter() - t0
            tokens = out.cpu().numpy().astype(np.int32)
        return {"tokens": tokens,
                "prefill_s": t_prefill,
                "decode_s": t_decode,
                "decode_tok_per_s": B * max_new_tokens / max(t_decode, 1e-9)}
