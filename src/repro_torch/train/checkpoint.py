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
from torch import nn

from .. import resolve_device
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
    """A copy on the host (never a view of a CPU tensor that may change)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _flatten(state, prefix: str = "") -> dict[str, np.ndarray]:
    """The reference's ``_flatten``: '/'-joined key paths to host arrays."""
    named = _named(state)
    if named is not None:
        state = stack_leaves(named)
    if isinstance(state, (dict, list, tuple)):
        flat = {}
        for k, x in _items(state):
            flat.update(_flatten(x, f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: _host(state)}


def _pairs(target, flat: dict, prefix: str = ""):
    """(tensor or array of ``target``, its array in ``flat``, its key)."""
    named = _named(target)
    if named is not None:
        for name, t in named.items():
            path, layer = reference_key(name)
            key = prefix + "/".join(path)
            arr = _lookup(flat, key)
            yield t, arr if layer is None else arr[layer], key
    elif isinstance(target, (dict, list, tuple)):
        for k, x in _items(target):
            yield from _pairs(x, flat, f"{prefix}{k}/")
    else:
        yield target, _lookup(flat, prefix[:-1]), prefix[:-1]


def _lookup(flat: dict, key: str) -> np.ndarray:
    if key not in flat:
        raise KeyError(f"checkpoint has no array {key!r}")
    return flat[key]


def _fill(target, flat: dict, device: torch.device) -> None:
    """Copy ``flat`` into the tensors (or arrays) of ``target`` in place,
    once every shape and device has been checked."""
    pairs = list(_pairs(target, flat))
    for t, arr, key in pairs:
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} vs "
                             f"{tuple(t.shape)}")
        if isinstance(t, torch.Tensor) and t.device.type != device.type:
            raise ValueError(f"{key} lies on {t.device}; asked for {device}")
    with torch.no_grad():
        for t, arr, _ in pairs:
            if isinstance(t, np.ndarray):
                np.copyto(t, arr.astype(t.dtype))
            else:
                t.copy_(torch.tensor(arr))


@dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = True
    _thread: Optional[threading.Thread] = field(default=None, repr=False)
    _error: Optional[BaseException] = field(default=None, repr=False)

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    # -- save -------------------------------------------------------------------
    def save(self, step: int, state, extra: Optional[dict] = None) -> None:
        """Copy ``state`` to the host now; write it (on a thread if
        ``async_save``). One save in flight at a time; a failed write
        raises at the next ``save`` or ``wait``."""
        self.wait()
        host_flat = _flatten(state)
        manifest = {"step": step, "time": time.time(),
                    "n_arrays": len(host_flat), **(extra or {})}

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
        if self._thread is not None:
            self._thread.join()
            self._thread = None
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
        ``device`` (default ``cuda``; raises where CUDA is absent)."""
        if shardings is not None:
            raise NotImplementedError(
                "elastic restore (shardings=) comes with the distributed "
                "item of ROADMAP.md")
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:09d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        _fill(target, flat, dev)
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
