"""Checkpoints in the reference's on-disk format, ported from
``repro.train.checkpoint``, so a checkpoint written by either package
restores in the other:

  * ``step_{N:09d}/arrays.npz`` keyed by the reference's flattened key
    paths, e.g. ``0/embed``, ``0/segments/0/b0/attn/wq`` (stacked over
    layers), ``1/m/...``, ``1/v/...``, ``1/step`` for ``(model, opt_state)``,
    and ``manifest.json`` (step, time, array count, the caller's extras:
    the loader's cursor);
  * atomic commits: written to ``step_N.tmp/``, the manifest fsynced, then
    renamed; restore takes the latest *complete* step;
  * async saves: the device-to-host copy is synchronous, only the disk
    write runs on a thread;
  * keep-N garbage collection, and reaping of ``.tmp`` directories older
    than 5 minutes (crashed writers).

A state is a tree of tuples, lists and dicts with tensors (or arrays) at
its leaves. A ``Model`` stands for its parameters, and a dict keyed by
parameter names (the optimizer's ``m`` and ``v``, whose names hold a
``.``) for those tensors: both are stored in the reference's layout
(``models.convert.stack_leaves``). ``restore`` fills such a tree in place.

DTensors (a sharded model and its optimizer state) are saved whole: every
rank gathers each one (``full_tensor``, a collective, so every rank calls
``save``), and rank 0 alone writes; ``wait`` returns on every rank once the
step is on disk. ``restore`` fills a DTensor's local shard from its slice
of the saved array, with no collective, so a checkpoint saved from one
mesh restores onto another (``train.elastic``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from .. import resolve_device
from ..models.base import by_name
from ..models.convert import reference_key, stack_leaves

MANIFEST = "manifest.json"


def _named(node) -> Optional[dict]:
    """{parameter name: tensor} for a module or a dict keyed by parameter
    names; None for any other node."""
    if isinstance(node, nn.Module):
        return dict(node.named_parameters())
    if (isinstance(node, dict) and any("." in str(k) for k in node)
            and all(isinstance(x, torch.Tensor) for x in node.values())):
        return node
    return None


def _items(node):
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    return [(str(i), x) for i, x in enumerate(node)]


def _host(x) -> np.ndarray:
    """A copy on the host (never a view of a CPU tensor that may change); a
    DTensor whole."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _has_dtensor(state) -> bool:
    named = _named(state)
    if named is not None:
        return any(isinstance(x, DTensor) for x in named.values())
    if isinstance(state, (dict, list, tuple)):
        return any(_has_dtensor(x) for _, x in _items(state))
    return isinstance(state, DTensor)


def _flatten(state, prefix: str = "") -> dict[str, np.ndarray]:
    """The reference's ``_flatten``: '/'-joined key paths to host arrays."""
    named = _named(state)
    if named is not None:
        state = stack_leaves({k: _host(x) for k, x in named.items()})
    if isinstance(state, (dict, list, tuple)):
        flat = {}
        for k, x in _items(state):
            flat.update(_flatten(x, f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: _host(state)}


def _pairs(target, flat: dict, shardings=None, prefix: str = ""):
    """(tensor or array of ``target``, its array in ``flat``, its key, its
    sharding in ``shardings`` or None)."""
    named = _named(target)
    if named is not None:
        for name, t in named.items():
            path, layer = reference_key(name)
            key = prefix + "/".join(path)
            arr = _lookup(flat, key)
            sh = by_name(shardings, name) if shardings is not None else None
            yield t, arr if layer is None else arr[layer], key, sh
    elif isinstance(target, (dict, list, tuple)):
        for k, x in _items(target):
            sub = None if shardings is None else (
                shardings[k] if isinstance(shardings, dict)
                else shardings[int(k)])
            yield from _pairs(x, flat, sub, f"{prefix}{k}/")
    else:
        yield target, _lookup(flat, prefix[:-1]), prefix[:-1], shardings


def _lookup(flat: dict, key: str) -> np.ndarray:
    if key not in flat:
        raise KeyError(f"checkpoint has no array {key!r}")
    return flat[key]


def _fill(target, flat: dict, device: torch.device, shardings=None) -> None:
    """Copy ``flat`` into the tensors (or arrays) of ``target`` in place,
    once every shape, device and sharding has been checked. A DTensor takes
    its local shard's slice; ``shardings`` (a tree matching ``target``, a
    declaration-shaped one for a model or a name-keyed dict, of ``(mesh,
    placements)``) states the placements each must have."""
    pairs = list(_pairs(target, flat, shardings))
    for t, arr, key, sh in pairs:
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} vs "
                             f"{tuple(t.shape)}")
        if isinstance(t, torch.Tensor) and t.device.type != device.type:
            raise ValueError(f"{key} lies on {t.device}; asked for {device}")
        if sh is not None and not (
                isinstance(t, DTensor) and t.device_mesh == sh[0]
                and tuple(t.placements) == tuple(sh[1])):
            raise ValueError(f"{key}: the target is not placed as asked "
                             f"({sh[1]} on {sh[0]})")
    with torch.no_grad():
        for t, arr, _, _ in pairs:
            if isinstance(t, np.ndarray):
                np.copyto(t, arr.astype(t.dtype))
            elif isinstance(t, DTensor):
                whole = torch.tensor(arr).to(t.device, t.dtype)
                t.to_local().copy_(distribute_tensor(
                    whole, t.device_mesh, t.placements,
                    src_data_rank=None).to_local())
            else:
                t.copy_(torch.tensor(arr))


@dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = True
    _thread: Optional[threading.Thread] = field(default=None, repr=False)
    _error: Optional[BaseException] = field(default=None, repr=False)
    _sharded: bool = field(default=False, repr=False)

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    # -- save -------------------------------------------------------------------
    def save(self, step: int, state, extra: Optional[dict] = None) -> None:
        """Copy ``state`` to the host now; write it (on a thread if
        ``async_save``). One save in flight at a time; a failed write
        raises at the next ``save`` or ``wait``. A state that holds
        DTensors is gathered on every rank and written by rank 0."""
        self.wait()
        host_flat = _flatten(state)
        manifest = {"step": step, "time": time.time(),
                    "n_arrays": len(host_flat), **(extra or {})}
        self._sharded = _has_dtensor(state)
        if self._sharded and tdist.get_rank() != 0:
            return

        def commit():
            tmp = os.path.join(self.directory, f"step_{step:09d}.tmp")
            final = os.path.join(self.directory, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host_flat)
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, final)  # atomic commit
            self._gc()

        if self.async_save:
            def run():
                try:
                    commit()
                except BaseException as e:  # surfaced on next save/wait
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            commit()

    def wait(self) -> None:
        """Until the last save is on disk (on every rank, after a save of
        DTensors); raises its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            tdist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore -----------------------------------------------------------------
    def _complete_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(path, MANIFEST)):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self._complete_steps()
        return steps[-1] if steps else None

    def restore(self, target, step: Optional[int] = None, *, shardings=None,
                device=None) -> tuple[object, dict]:
        """Fill ``target`` (the tree that was saved, e.g. ``(model,
        opt_state)``) in place from ``step`` (default: the latest complete
        one); returns (target, manifest). Its tensors must lie on
        ``device`` (default ``cuda``; raises where CUDA is absent). Each
        DTensor takes its local shard; ``shardings`` (see ``_fill``; the
        elastic path) states the placements the target must have."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:09d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        _fill(target, flat, dev, shardings)
        return target, manifest

    # -- GC ------------------------------------------------------------------------
    def _gc(self) -> None:
        steps = self._complete_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
        # reap stale tmp dirs (crashed writers)
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                full = os.path.join(self.directory, name)
                if time.time() - os.path.getmtime(full) > 300:
                    shutil.rmtree(full, ignore_errors=True)
