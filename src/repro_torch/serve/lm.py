"""Batched serving engine, ported from ``repro.serve.lm``: prefill once,
then decode greedily."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device


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
        with torch.inference_mode():
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
            tok = logits.argmax(dim=-1)[:, None]
            t0 = time.perf_counter()
            for i in range(max_new_tokens):
                out[:, i] = tok[:, 0]
                logits, cache = self.model.decode_step(cache, tok)
                tok = logits.argmax(dim=-1)[:, None]
            self._sync()
            t_decode = time.perf_counter() - t0
            tokens = out.cpu().numpy().astype(np.int32)
        return {"tokens": tokens,
                "prefill_s": t_prefill,
                "decode_s": t_decode,
                "decode_tok_per_s": B * max_new_tokens / max(t_decode, 1e-9)}
