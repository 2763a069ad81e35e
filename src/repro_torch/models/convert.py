"""Carry the JAX package's parameters into the port.

``load_jax_params(model, tree)`` takes the reference's parameter tree as
numpy arrays (``jax.tree.map(np.asarray, params)``) and copies it into the
port's ``Model``. The reference stacks each block over a leading ``layers``
axis (``segments[si]["b{j}"]``); here each layer is its own module, so
``segments.si.bj.<leaf>[i]`` becomes ``segments.si.bj.i.<leaf>``. Layouts
are kept as they are (``wq [d, H, D]``, ``wo [H, D, d]``, ``embed [V, d]``).
``stack_leaves`` is the inverse: the port's per-layer tensors restacked into
the reference's tree, as checkpoints and the optimizer's state store them.
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


def reference_key(name: str) -> tuple[list[str], int | None]:
    """A port parameter name as (the reference's key path, layer index):
    ``segments.0.b0.3.attn.wq`` -> (["segments", "0", "b0", "attn", "wq"],
    3); ``final_norm.scale`` -> (["final_norm", "scale"], None)."""
    parts = name.split(".")
    if parts[0] == "segments":
        return parts[:3] + parts[4:], int(parts[3])
    return parts, None


def stack_leaves(named) -> dict:
    """``{port parameter name: tensor or array}`` -> the reference's tree
    of numpy arrays, ``segments[si]["b{j}"][<leaf>]`` stacked over layers
    (the inverse of ``jax_leaves``). Raises on a missing layer."""
    layers: dict[tuple, dict[int, np.ndarray]] = {}
    tree: dict = {}
    for name, x in named.items():
        arr = (x.detach().to("cpu", copy=True).numpy()
               if isinstance(x, torch.Tensor) else np.array(x))
        path, layer = reference_key(name)
        if layer is None:
            _put(tree, path, arr)
        else:
            layers.setdefault(tuple(path), {})[layer] = arr
    for path, by_layer in layers.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{'/'.join(path)}: layers {sorted(by_layer)}")
        _put(tree, list(path), np.stack([by_layer[i]
                                         for i in range(len(by_layer))]))
    if "segments" in tree:
        segs = tree["segments"]
        tree["segments"] = [segs[str(i)] for i in range(len(segs))]
    return tree


def _put(tree: dict, path: list[str], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value
