"""Specs as DTensor placements: a spec is the reference's ``PartitionSpec``
as a tuple, one entry a tensor dimension, each None, a mesh-axis name or a
tuple of names (``models.base.spec_tree`` derives them from the rules).
"""

from __future__ import annotations

import math

from torch.distributed.tensor import Partial, Replicate, Shard


def placements(spec: tuple, mesh, shape=None) -> tuple:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for ``spec``:
    ``Shard(d)`` on each mesh axis that tensor dimension d names (a tuple
    such as ``("pod", "data")`` shards d over both, the first outermost),
    ``Replicate()`` on the others. Given the tensor's ``shape``, an entry
    whose mesh-axis product does not divide its dimension is dropped
    (``spec_tree``'s rule: a batch of 3 rows replicates over data = 2)."""
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for dim, part in enumerate(spec):
        parts = part if isinstance(part, tuple) else (part,)
        if shape is not None and part is not None and shape[dim] % \
                math.prod(mesh.size(names.index(a)) for a in parts):
            continue
        for a in parts:
            if a is not None:
                if not isinstance(out[names.index(a)], Replicate):
                    raise ValueError(f"mesh axis {a!r} shards two dims of "
                                     f"{spec}")
                out[names.index(a)] = Shard(dim)
    return tuple(out)


def grad_placements(inp: tuple, out: tuple) -> tuple:
    """The placements of an input's gradient under ``local_map`` for a
    function whose outputs are placed ``out``: where the input is
    replicated but the output sharded, each rank's gradient is a partial
    sum; elsewhere the gradient is placed as the input."""
    return tuple(Partial() if isinstance(i, Replicate) and isinstance(o, Shard)
                 else i for i, o in zip(inp, out))


def local_range(n: int, mesh, plc, dim: int) -> tuple[int, int]:
    """(first index, count) of this rank's slice of a tensor dim of size n
    under placements ``plc``: DTensor's ``Shard`` splits into ceil-sized
    chunks, mesh dims in order."""
    lo, size = 0, n
    coord = mesh.get_coordinate()
    for i, p in enumerate(plc):
        if isinstance(p, Shard) and p.dim == dim:
            c = -(-size // mesh.size(i))
            start = min(c * coord[i], size)
            lo, size = lo + start, min(start + c, size) - start
    return lo, size
