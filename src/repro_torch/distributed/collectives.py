"""The reference's ``shard_map`` collectives on a ``DeviceMesh``, for code
that runs on local shards under ``local_map``.

``psum`` and ``pmean`` differentiate as ``shard_map``'s do for an output
that every rank of the group then uses whole (``local_map`` hands each
rank the same cotangent): the cotangent of ``psum`` passes through, that of
``pmean`` is divided by the group's size. ``torch.distributed.nn``'s
``all_reduce`` sums the cotangents instead, which would count them once per
rank. ``mesh_sum`` is the non-differentiable sum over every rank.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as tdist


def _groups(mesh, axes) -> list:
    names = list(mesh.mesh_dim_names)
    return [mesh.get_group(names.index(a)) for a in axes]


def _all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    for g in groups:
        tdist.all_reduce(out, group=g)
    return out


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, scale):
        ctx.scale = scale
        out = _all_reduce(x, groups)
        return out if scale == 1 else out * scale

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.scale == 1 else grad * ctx.scale), None, None


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum of ``x`` over the ranks along mesh ``axes`` (names)."""
    return _Reduce.apply(x, _groups(mesh, axes), 1)


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Mean of ``x`` over the ranks along mesh ``axes`` (names)."""
    n = math.prod(mesh.size(list(mesh.mesh_dim_names).index(a)) for a in axes)
    return _Reduce.apply(x, _groups(mesh, axes), 1.0 / n)


@torch.no_grad()
def mesh_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of ``x`` over every rank of ``mesh`` (no gradient)."""
    return _all_reduce(x, _groups(mesh, mesh.mesh_dim_names))
