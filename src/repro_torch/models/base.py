"""Parameter declaration trees, as in ``repro.models.base``.

A model is declared as a nested dict (and list) of ``P`` leaves. From one
declaration the port derives its parameters (``init_tree``), their shapes
on the ``meta`` device (``abstract_tree``), their count (``param_count``),
their sharding specs (``spec_tree``, by the logical-axis ``ShardingRules``)
and an ``nn.Module`` that holds them (``ParamTree``), whose parameter names
are the declaration's key paths, e.g. ``segments.0.b0.3.attn.wq`` for layer
3 of block 0 of segment 0.

A spec is the reference's ``PartitionSpec`` as a tuple: one entry a tensor
dimension, each None, a mesh-axis name or a tuple of names.
``repro_torch.distributed.placement`` turns it into DTensor placements on a
``DeviceMesh``; ``constrain`` is the
reference's ``with_sharding_constraint``, a ``redistribute`` of a DTensor.

Logical axes: "embed", "heads", "kv_heads", "head_dim", "ff", "vocab",
"experts", "lru", "conv", "layers" (never sharded), None.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor


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
    """Apply ``fn`` to every leaf of a dict/list tree (a tuple, such as a
    spec, is a leaf); dict keys in sorted order (as ``jax.tree`` flattens
    them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, x) for x in tree]
    return fn(tree)


def by_name(tree, name: str):
    """The node of a declaration-shaped tree at a parameter name, e.g.
    ``segments.0.b0.3.attn.wq``."""
    for part in name.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


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


def abstract_tree(decl, dtype=torch.float32):
    """The declaration as tensors on the ``meta`` device: shapes and dtype,
    no storage (the reference's ``ShapeDtypeStruct`` tree)."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=dtype,
                                          device="meta"), decl)


def param_count(decl) -> int:
    return sum(math.prod(p.shape) for p in tree_leaves(decl))


# ---------------------------------------------------------------------------
# logical-axis -> mesh-axis rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical parameter/activation axes onto mesh axes."""

    embed: Any = "data"        # FSDP / ZeRO-3: weight d_model dim over data
    heads: Any = "model"       # Megatron TP
    kv_heads: Any = "model"
    head_dim: Any = None
    ff: Any = "model"
    vocab: Any = "model"
    experts: Any = "model"     # EP when divisible (checked per model)
    lru: Any = "model"
    conv: Any = None
    batch: Any = ("pod", "data")
    seq: Any = None            # SP for long-context decode
    kv_seq: Any = None
    layers: Any = None

    def spec_for(self, axes: tuple[Optional[str], ...]) -> tuple:
        return tuple(getattr(self, a) if a else None for a in axes)


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of anything with
    ``axis_names`` and a ``shape`` mapping (the reference's ``Mesh``)."""
    if isinstance(mesh.shape, Mapping):
        return {a: int(mesh.shape[a]) for a in mesh.axis_names}
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def spec_tree(decl, rules: ShardingRules, mesh=None):
    """Specs per leaf; when ``mesh`` is given, drop shardings whose
    mesh-axis product does not divide the dimension (e.g. GQA kv_heads=8
    on model=16: those weights replicate across TP ranks)."""
    sizes = mesh_axes(mesh) if mesh is not None else None

    def leaf(p: P):
        spec = rules.spec_for(p.axes)
        if sizes is None:
            return spec
        fixed = []
        for dim, part in zip(p.shape, spec):
            parts = part if isinstance(part, tuple) else (part,)
            prod = math.prod(sizes[a] for a in parts) if part else 1
            fixed.append(part if part is not None and dim % prod == 0
                         else None)
        return tuple(fixed)

    return tree_map(leaf, decl)


def constrain(x, rules: ShardingRules, axes: tuple[Optional[str], ...]):
    """The reference's sharding constraint by logical axes: a DTensor is
    redistributed to the placements ``axes`` ask for, less the shardings
    its shape does not divide (the reference leaves such an array as it
    is); a plain tensor (no mesh) is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    # imported here: the distributed package imports this module
    from ..distributed.placement import placements
    want = placements(rules.spec_for(axes), x.device_mesh, x.shape)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


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
