"""Batched serving engine, ported from ``repro.serve.lm``: prefill once,
then decode greedily. A sharded model (``build(cfg, dist=...)``) serves
through the same entry: its caches are DTensors, and logits that come
back sharded (over the vocab) are gathered whole before the argmax.

A model whose decode step can be captured (``Model.capturable_decode``)
keeps one cache in the engine, for the batch size of its last call,
filled anew by each call's prefill; a call of another batch size
replaces it. On CUDA the step is captured once for that cache as a CUDA
graph (embedding, layers, logits, the argmax into the static token and
the position's advance) and replayed for every later step: the host
launches one replay and one copy of the token a step. The other models
decode eagerly, a new cache a call. Counters
``bullion.serve.decode_graph_captures``,
``bullion.serve.decode_graph_replays`` and
``bullion.serve.decode_eager_steps`` count the captures and the steps of
either kind (the eager steps that warm up a capture count as neither);
the counters that the captured step increments (the MoE's, say) are
incremented by each replay as well, so that they count replayed steps as
they count eager ones. The ``serve.decode`` span carries a call's
``graph_steps`` and ``eager_steps``."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from .. import resolve_device
from ..obs import metrics as _metrics
from ..obs import trace as _trace

# eager steps on a side stream before a capture (``torch.cuda.graphs``:
# lazy initialisation, such as cuBLAS's workspaces, stays out of the graph)
WARMUP_STEPS = 2


def _greedy(logits) -> torch.Tensor:
    """The argmax token [B, 1] of logits [B, V], gathered whole first where
    they are a DTensor."""
    if isinstance(logits, DTensor):
        logits = logits.full_tensor()
    return logits.argmax(dim=-1)[:, None]


@dataclass
class _Kept:
    """What the engine keeps for batch size ``B``: the cache, and on CUDA
    the static token [B, 1] each step reads and overwrites with its
    successor, the captured step, its logits, and the counters' increments
    of one step (name to increment)."""
    B: int
    cache: dict
    tok: Optional[torch.Tensor] = None
    graph: Optional[object] = None
    logits: Optional[torch.Tensor] = None
    counts: dict = field(default_factory=dict)


def _counters() -> dict:
    return {n: v for n, v in _metrics.snapshot().items()
            if not isinstance(v, dict)}


@dataclass
class ServeEngine:
    model: object
    max_seq: int
    device: object = None   # default cuda; must be the model's device
    _kept: Optional[_Kept] = field(default=None, init=False, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.model.device.type != self.device.type:
            raise ValueError(f"model on {self.model.device}, engine asked "
                             f"for {self.device}")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _keep(self, B: int) -> Optional[_Kept]:
        """The kept state for batch size ``B``: the last call's where it was
        of ``B`` too, else made anew in its place (the old cache and graph
        let go first, so that the engine holds one at most); None for a
        model whose decode step cannot be captured."""
        if not self.model.capturable_decode:
            return None
        if self._kept is None or self._kept.B != B:
            self._kept = None
            self._kept = _Kept(B, self.model.init_cache(
                B, self.max_seq, dtype=torch.float32))
        return self._kept

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
            kept = self._keep(B)
            cache = kept.cache if kept is not None else \
                self.model.init_cache(B, self.max_seq, dtype=torch.float32)
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
            with _trace.span("serve.decode", cat="serve",
                             steps=max_new_tokens, batch=B) as sp:
                t0 = time.perf_counter()
                if kept is not None and self.device.type == "cuda":
                    graph_steps, eager_steps = \
                        self._replay(kept, logits, out), 0
                else:
                    self._eager(cache, _greedy(logits), out)
                    graph_steps, eager_steps = 0, max_new_tokens
                    _metrics.counter("bullion.serve.decode_eager_steps") \
                        .inc(max_new_tokens)
                self._sync()
                t_decode = time.perf_counter() - t0
                sp.set(graph_steps=graph_steps, eager_steps=eager_steps)
            tokens = out.cpu().numpy().astype(np.int32)
        return {"tokens": tokens,
                "prefill_s": t_prefill,
                "decode_s": t_decode,
                "decode_tok_per_s": B * max_new_tokens / max(t_decode, 1e-9)}

    def _eager(self, cache: dict, tok, out) -> None:
        """Greedy decode from ``tok`` [B, 1] into ``out`` [B, n] by n eager
        steps, each overwriting ``tok`` with its successor."""
        for i in range(out.shape[1]):
            out[:, i] = tok[:, 0]
            logits, _ = self.model.decode_step(cache, tok)
            tok.copy_(_greedy(logits))

    def _replay(self, kept: _Kept, logits, out) -> int:
        """Greedy decode from the prefill's ``logits`` into ``out`` [B, n]
        by replays of ``kept``'s graph, captured first where it has none:
        ``WARMUP_STEPS`` eager steps on a side stream, then the capture
        (which runs nothing, and whose counters' increments stand for the
        first replay's), then replays from there, each incrementing the
        counters as the captured step did. Returns the replays."""
        model, cache, n = self.model, kept.cache, out.shape[1]
        start = 0
        if kept.graph is None:
            kept.tok = _greedy(logits)
            start = min(WARMUP_STEPS, n)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._eager(cache, kept.tok, out[:, :start])
            torch.cuda.current_stream(self.device).wait_stream(side)
            if start == n:
                return 0                # every step warmed up: capture later
            graph = torch.cuda.CUDAGraph()
            before = _counters()
            # other threads (a loader's, NCCL's watchdog) may go on with
            # their own CUDA calls while this one captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                step_logits = model.decode_body(cache, kept.tok)
                kept.tok.copy_(_greedy(step_logits))
            kept.counts = {name: v - before.get(name, 0)
                           for name, v in _counters().items()
                           if v != before.get(name, 0)}
            kept.graph, kept.logits = graph, step_logits
            _metrics.counter("bullion.serve.decode_graph_captures").inc()
            counted = 1             # the capture's increments: one step's
        else:
            kept.tok.copy_(_greedy(logits))
            counted = 0
        model.advance(cache, n - start)
        for i in range(start, n):
            out[:, i] = kept.tok[:, 0]
            kept.graph.replay()
        for name, d in kept.counts.items():
            _metrics.counter(name).inc(d * (n - start - counted))
        _metrics.counter("bullion.serve.decode_graph_replays").inc(n - start)
        return n - start
