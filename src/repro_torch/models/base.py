"""Parameter declaration trees, as in ``repro.models.base``.

A model is declared as a nested dict (and list) of ``P`` leaves. From one
declaration the port derives its parameters (``init_tree``), their count
(``param_count``) and an ``nn.Module`` that holds them (``ParamTree``), whose
parameter names are the declaration's key paths, e.g.
``segments.0.b0.3.attn.wq`` for layer 3 of block 0 of segment 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter declaration."""

    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | embed
    scale: Optional[float] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_decl(x) -> bool:
    return isinstance(x, P)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a dict/list tree; dict keys in sorted
    order (as ``jax.tree`` flattens them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, x) for x in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _init_leaf(p: P, generator: torch.Generator, device, dtype) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "embed":
        scale = p.scale or 1.0
    else:
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        scale = p.scale or (1.0 / math.sqrt(max(fan_in, 1)))
    x = torch.randn(p.shape, generator=generator, dtype=dtype, device=device)
    return x.mul_(scale)


def init_tree(decl, generator: torch.Generator, device,
              dtype=torch.float32):
    """Materialize a declaration: normal with scale ``1/sqrt(fan_in)``
    (``fan_in`` = shape[-2]), ``embed`` normal with its scale, zeros, ones.
    ``generator`` must live on ``device``."""
    return tree_map(lambda p: _init_leaf(p, generator, device, dtype), decl)


def param_count(decl) -> int:
    return sum(math.prod(p.shape) for p in tree_leaves(decl))


class ParamTree(nn.Module):
    """A dict/list tree of tensors as a module. Dict keys become attributes
    (``tree["attn"]["wq"]`` reads the same as on the plain dict), lists
    become ``nn.ModuleList``s. Parameters are registered with
    ``requires_grad=False``, so serving builds no graph; training makes
    them trainable with ``requires_grad_(True)``, which
    ``train.make_train_step`` calls."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
            elif isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.add_module(k, nn.ModuleList(ParamTree(x) for x in v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def as_tree(self, fn=lambda p: p):
        """The plain dict/list tree of ``fn(parameter)``, in the layout
        this module was built from (and reads the same)."""
        tree = {k: fn(p) for k, p in self._parameters.items()}
        for k, m in self._modules.items():
            tree[k] = ([x.as_tree(fn) for x in m]
                       if isinstance(m, nn.ModuleList) else m.as_tree(fn))
        return tree
