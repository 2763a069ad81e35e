"""Carry the JAX package's parameters into the port.

``load_jax_params(model, tree)`` takes the reference's parameter tree as
numpy arrays (``jax.tree.map(np.asarray, params)``) and copies it into the
port's ``Model``. The reference stacks each block over a leading ``layers``
axis (``segments[si]["b{j}"]``); here each layer is its own module, so
``segments.si.bj.<leaf>[i]`` becomes ``segments.si.bj.i.<leaf>``. Layouts
are kept as they are (``wq [d, H, D]``, ``wo [H, D, d]``, ``embed [V, d]``).
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix[:-1], tree
        return
    for k, v in items:
        yield from _flatten(v, f"{prefix}{k}.")


def jax_leaves(tree) -> dict[str, np.ndarray]:
    """The reference tree as ``{port parameter name: array}``, unstacked."""
    out = {}
    for path, arr in _flatten(tree):
        parts = path.split(".")
        if parts[0] == "segments":
            head, rest = ".".join(parts[:3]), ".".join(parts[3:])
            for i in range(arr.shape[0]):
                out[f"{head}.{i}.{rest}"] = arr[i]
        else:
            out[path] = arr
    return out


def load_jax_params(model: torch.nn.Module, tree) -> None:
    """Fill ``model``'s parameters from ``tree``; raises on any missing,
    extra or mis-shaped leaf."""
    src = jax_leaves(tree)
    params = dict(model.named_parameters())
    missing, extra = sorted(params.keys() - src.keys()), sorted(src.keys() - params.keys())
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing[:8]}, "
                         f"extra {extra[:8]}")
    for name, p in params.items():
        arr = np.asarray(src[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} vs {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.tensor(np.asarray(src[name], np.float32),
                                 dtype=p.dtype))
