"""Elastic scaling, ported from ``repro.train.elastic``: re-lay a training
state onto a different mesh.

Checkpoints are mesh-agnostic (whole arrays, ``train.checkpoint``). Growing
or shrinking the fleet = build the new mesh, derive the new placements from
the same logical-axis rules, and restore into a model built on it: each
rank reads its own slice, with no format migration. ``reshard_plan`` also
reports which parameters change their physical partitioning, in the
reference's terms (stacked key paths, ``PartitionSpec`` strings), which
the launcher logs on every elastic transition.
"""

from __future__ import annotations

from ..distributed import make_dist
from ..models.base import spec_tree, tree_map
from ..models.convert import reference_key


def shardings_for(decl, mesh, **rule_kw):
    """(mesh, placements) for every leaf of ``decl``."""
    dist = make_dist(mesh, **rule_kw)
    return tree_map(dist.sharding, spec_tree(decl, dist.rules, mesh))


def _named_leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _named_leaves(x, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _spec_str(spec: tuple) -> str:
    """The reference's ``str(PartitionSpec(*spec))``: a one-name tuple is
    written as the name."""
    norm = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)
    return f"PartitionSpec{norm!r}"


def reshard_plan(decl, old_mesh, new_mesh, **rule_kw) -> dict:
    """Summarize the partitioning delta between two meshes: the
    reference's dict, its parameters by their stacked key paths (a layer
    stack once, with its leading unsharded 'layers' axis)."""
    old = spec_tree(decl, make_dist(old_mesh, **rule_kw).rules, old_mesh)
    new = spec_tree(decl, make_dist(new_mesh, **rule_kw).rules, new_mesh)
    changed, seen = [], set()
    for (name, o), (_, n) in zip(_named_leaves(old), _named_leaves(new)):
        path, layer = reference_key(name)
        key = "/".join(path)
        if key in seen:
            continue
        seen.add(key)
        if layer is not None:
            o, n = (None, *o), (None, *n)
        if o != n:
            changed.append({"param": key, "old": _spec_str(o),
                            "new": _spec_str(n)})
    return {"old_devices": _size(old_mesh), "new_devices": _size(new_mesh),
            "changed": changed, "n_changed": len(changed)}


def _size(mesh) -> int:
    size = mesh.size
    return size() if callable(size) else int(size)


def elastic_restore(manager, template, decl, new_mesh, step=None,
                    **rule_kw):
    """Restore a checkpoint into ``template`` (a model built on
    ``new_mesh``, or a tree of its DTensors) whatever mesh it was saved
    from; returns (template, manifest)."""
    shardings = shardings_for(decl, new_mesh, **rule_kw)
    return manager.restore(template, step=step, shardings=shardings,
                           device=new_mesh.device_type)
