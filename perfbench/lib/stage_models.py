"""The bridge for a pipeline stage whose layers are too large to keep
their draws alive: ``perfbench/lib/models.py``'s configuration and
parameter names, with every parameter given storage of its own.

``models.build`` keeps each parameter as it comes from
``models.program_params``: views of the layer's one normal draw
(``perfbench/gen/weights.py``), and, where an expert has two chunks, new
copies of ``wg`` and ``wu`` in the chunk layout. The views keep the whole
draw alive beside the copies: for mixtral-8x22b, 5.0 GB of draw and 3.2 GB
of copies a layer, 8.2 GB where the weights are 5.0 GB. Here every
parameter that shares its storage, or lies in a larger one, is cloned, and
the draw is freed before the next layer is drawn.
"""

from __future__ import annotations

from perfbench.lib import models


def owns_storage(t) -> bool:
    """Whether ``t`` is the whole of its storage."""
    return t.untyped_storage().nbytes() == t.numel() * t.element_size() \
        and t.storage_offset() == 0


def build(cfg: dict, seed: int, device, dtype):
    """The program's ``Model`` (``repro_torch.models.zoo.build``, shapes on
    ``meta``) with every parameter replaced by the benchmark's weights, each
    in storage of its own."""
    import torch
    from repro_torch.models.zoo import build as build_model
    model = build_model(models.port_config(cfg), device="meta", dtype=dtype)
    want = dict(model.named_parameters())
    for layer in range(-1, cfg["num_hidden_layers"]):
        params = models.program_params(cfg, seed, layer, device, dtype)
        for name, t in params.items():
            if tuple(want[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: {tuple(t.shape)} for "
                                 f"{tuple(want[name].shape)}")
            if not owns_storage(t):
                t = t.clone(memory_format=torch.contiguous_format)
            mod, leaf = name.rsplit(".", 1) if "." in name else ("", name)
            model.get_submodule(mod)._parameters[leaf] = \
                torch.nn.Parameter(t, requires_grad=False)
        del params
    left = [n for n, p in model.named_parameters() if p.is_meta]
    if left:
        raise ValueError(f"parameters not made: {left[:4]}")
    return model
