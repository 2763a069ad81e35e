"""Per-layer views of a stacked serving cache, and the writes into it.

A cache keeps each block's tensors stacked over the segment's layers,
``[L, ...]`` (``transformer.init_cache``, ``encdec.encdec_cache``). A layer
reads its slice ``t[i]`` (``LayerCache``) and writes through ``put``,
in place, or through ``put_slot`` at a slot held on the device.

Sharded serving holds the stacked tensors as DTensors, placed by
``launch.dryrun.cache_specs`` (batch over the batch axes, or the
sequence over 'data', heads or head dim over 'model'). There a write
through a DTensor view (``__setitem__`` on ``t[i][:, slot]``) may
redistribute into a temporary and lose the write without an error, so
``put`` writes into each rank's local shard: the value is placed as the
destination's shards where the write covers that dimension whole and
replicated where it covers part of it, and each rank copies the part of
the region that its shard holds.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.placement import local_range


class LayerCache:
    """Layer ``layer`` of one block's stacked cache tensors ``stacked``
    ({name: [L, ...]}): ``cache[name]`` reads ``stacked[name][layer]``;
    ``put`` writes into the stack."""

    def __init__(self, stacked: dict, layer: int):
        self.stacked, self.layer = stacked, layer

    def __getitem__(self, name: str):
        return self.stacked[name][self.layer]


def put(cache, name: str, value, index: tuple = ()) -> None:
    """``cache[name][index] = value`` in place, in the cache's dtype:
    ``cache`` a ``LayerCache`` or a dict of one layer's tensors, ``index``
    ints and step-1 slices over the leading dims (``()``: the whole
    tensor), ``value`` a tensor or a number."""
    if isinstance(cache, LayerCache):
        t, index = cache.stacked[name], (cache.layer, *index)
    else:
        t = cache[name]
    if isinstance(t, DTensor):
        _local_put(t, index, value)
    else:
        t[index] = value


def put_slot(cache, name: str, value: torch.Tensor,
             slot: torch.Tensor) -> None:
    """``cache[name][:, slot] = value[:, 0]`` in place, in the cache's dtype,
    at a slot held on the device (a 0-d tensor): ``index_copy_`` along the
    slot dim, so that the write is the same op at every slot. ``value`` [B,
    1, ...]; plain tensors only (a sharded cache writes through ``put``)."""
    t = cache.stacked[name][cache.layer] if isinstance(cache, LayerCache) \
        else cache[name]
    t.index_copy_(1, slot.view(1), value.to(t.dtype))


def _ranges(index: tuple, shape) -> list:
    """Per dim of ``shape``: (start, stop, is_int) of ``index``."""
    out = []
    for d, n in enumerate(shape):
        ix = index[d] if d < len(index) else slice(None)
        if isinstance(ix, int):
            i = ix % n
            out.append((i, i + 1, True))
        else:
            start, stop, step = ix.indices(n)
            if step != 1:
                raise ValueError(f"a cache write takes step-1 slices: {ix}")
            out.append((start, max(start, stop), False))
    return out


def _local_put(dst: DTensor, index: tuple, value) -> None:
    mesh, plc = dst.device_mesh, tuple(dst.placements)
    rng = _ranges(index, dst.shape)
    # the value's dims: the destination's less those indexed by an int
    vdims = [d for d, (_, _, is_int) in enumerate(rng) if not is_int]
    whole = {d for d in vdims
             if rng[d][0] == 0 and rng[d][1] == dst.shape[d]}
    vplc = tuple(Shard(vdims.index(p.dim)) if isinstance(p, Shard)
                 and p.dim in whole else Replicate() for p in plc)
    if isinstance(value, torch.Tensor):
        if not isinstance(value, DTensor):
            value = DTensor.from_local(value, mesh, (Replicate(),) * mesh.ndim,
                                       run_check=False)
        value = value.redistribute(mesh, vplc)
        vshape, vlocal = value.shape, value.to_local()
    local = dst.to_local()
    didx, vidx = [], []
    for d, (r0, r1, is_int) in enumerate(rng):
        lo, n = local_range(dst.shape[d], mesh, plc, d)
        a, b = max(lo, r0), min(lo + n, r1)
        if a >= b:
            return                      # this rank holds none of the region
        if is_int:
            didx.append(a - lo)
            continue
        didx.append(slice(a - lo, b - lo))
        if isinstance(value, torch.Tensor):
            vd = len(vidx)
            vlo, _ = local_range(vshape[vd], mesh, vplc, vd)
            vidx.append(slice(a - r0 - vlo, b - r0 - vlo))
    if isinstance(value, torch.Tensor):
        local[tuple(didx)] = vlocal[tuple(vidx)]
    else:
        local[tuple(didx)] = value
