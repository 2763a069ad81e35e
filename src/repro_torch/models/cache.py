"""Per-layer views of a stacked serving cache, and the writes into it.

A cache keeps each block's tensors stacked over the segment's layers,
``[L, ...]`` (``transformer.init_cache``, ``encdec.encdec_cache``). A layer
reads its slice ``t[i]`` (``LayerCache``) and writes in place, through
``put`` or, at a slot held on the device, ``put_slot``.

Sharded serving holds the stacked tensors as DTensors, placed by
``launch.dryrun.cache_specs`` (batch over the batch axes, or the
sequence over 'data', heads or head dim over 'model'). There a write
through a DTensor view (``__setitem__`` on ``t[i][:, slot]``) may
redistribute into a temporary and lose the write without an error, so
both write into each rank's local shard: the value is placed as the
destination's shards where the write covers that dimension whole and
replicated where it covers part of it, and each rank copies the part of
the region that its shard holds (a slot on the device: masked).
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
    ints, step-1 slices and 0-d tensors (slots on the device) over the
    leading dims (``()``: whole), ``value`` a tensor or a number."""
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
    slot dim (a DTensor through ``put``), the same ops at every slot and no
    read of it on the host. ``value`` [B, 1, ...]."""
    t = cache.stacked[name][cache.layer] if isinstance(cache, LayerCache) \
        else cache[name]
    if isinstance(t, DTensor):
        put(cache, name, value[:, 0], (slice(None), slot))
    else:
        t.index_copy_(1, slot.view(1), value.to(t.dtype))


def _ranges(index: tuple, shape) -> list:
    """Per dim of ``shape``: (start, stop, is_int) of ``index``, a slot on
    the device (a 0-d tensor) an int anywhere in the dim."""
    out = []
    for d, n in enumerate(shape):
        ix = index[d] if d < len(index) else slice(None)
        if isinstance(ix, torch.Tensor):
            out.append((0, n, True))
        elif isinstance(ix, int):
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
    didx, vidx, slot = [], [], None
    for d, (r0, r1, is_int) in enumerate(rng):
        lo, n = local_range(dst.shape[d], mesh, plc, d)
        a, b = max(lo, r0), min(lo + n, r1)
        if a >= b:
            return                      # this rank holds none of the region
        if is_int and isinstance(index[d], torch.Tensor):
            # the slot: (its dim in the view, its place in this shard)
            slot, at = len(vidx), index[d] - lo
            didx.append(slice(None))
            continue
        if is_int:
            didx.append(a - lo)
            continue
        didx.append(slice(a - lo, b - lo))
        if isinstance(value, torch.Tensor):
            vd = len(vidx)
            vlo, _ = local_range(vshape[vd], mesh, vplc, vd)
            vidx.append(slice(a - r0 - vlo, b - r0 - vlo))
    if slot is not None:    # at the slot clamped into the shard, masked
        view = local[tuple(didx)]
        i = at.clamp(0, view.shape[slot] - 1).view(1)
        new = vlocal[tuple(vidx)].unsqueeze(slot).to(view.dtype)
        view.index_copy_(slot, i, torch.where(at == i, new,
                                              view.index_select(slot, i)))
    elif isinstance(value, torch.Tensor):
        local[tuple(didx)] = vlocal[tuple(vidx)]
    else:
        local[tuple(didx)] = value
