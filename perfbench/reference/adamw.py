"""Plain reference of the configured optimizer: AdamW with a linear
warmup then a cosine decay of the learning rate to ``min_lr_frac`` of it,
the gradients first clipped by their global norm (divided by
``max(norm, 1e-9)``), weight decay on every leaf, f32 moments. It imports
nothing of the program."""

from __future__ import annotations

import math

import torch


class AdamW:
    def __init__(self, params: dict, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, warmup_steps=100, total_steps=10000,
                 min_lr_frac=0.1, clip_norm=1.0):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.warmup, self.total = weight_decay, warmup_steps, total_steps
        self.min_frac, self.clip = min_lr_frac, clip_norm
        self.m = {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()}
        self.v = {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()}
        self.t = 0

    def rate(self, t: int) -> float:
        if t < self.warmup:
            return self.lr * t / max(self.warmup, 1)
        frac = min(max((t - self.warmup) / max(self.total - self.warmup, 1),
                       0.0), 1.0)
        return self.lr * (self.min_frac + (1 - self.min_frac) * 0.5
                          * (1 + math.cos(math.pi * frac)))

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """One update; returns each leaf's norm of its clipped gradient."""
        self.t += 1
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
        scale = torch.clamp(self.clip / torch.clamp(norm, min=1e-9), max=1.0)
        lr = self.rate(self.t)
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        norms = {}
        for k, p in self.params.items():
            g = grads[k].float() * scale
            norms[k] = float(torch.linalg.vector_norm(g))
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            delta = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + self.eps) \
                + self.wd * p
            p.sub_(lr * delta)
        return norms
