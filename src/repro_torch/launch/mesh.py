"""Mesh definitions, ported from ``repro.launch.mesh`` onto
``torch.distributed``: the production meshes as data, a small mesh for
tests, and the per-card hardware constants the roofline analysis uses.

The meshes are built over the current process group
(``torch.distributed.init_process_group`` must have run), on the device
type of its backend: ``cuda`` for NCCL, ``cpu`` for gloo.
"""

from __future__ import annotations

import math

import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh

# NVIDIA H100 SXM5 80GB at 700 W, data-sheet figures (per card)
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense BF16
HBM_BW = 3.35e12               # B/s, HBM3
NVLINK_BW = 450e9              # B/s, NVLink 4, each direction

# the production meshes: (shape, axis names), by multi_pod
PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def _device_type() -> str:
    return "cuda" if tdist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    world, need = tdist.get_world_size(), math.prod(shape)
    if world != need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh {axes} needs "
                         f"a world size of {need}; the process group has "
                         f"{world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``; raises unless the world size is 256 or
    512 respectively."""
    return _mesh(*PRODUCTION_MESHES[multi_pod])


def make_test_mesh(data: int = 2, model: int = 4):
    """A small ("data", "model") mesh; the world size must be data * model."""
    return _mesh((data, model), ("data", "model"))
