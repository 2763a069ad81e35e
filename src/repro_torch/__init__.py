"""PyTorch and CUDA port of the ``repro`` package, for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it and keeps its own copy of what it needs. The first slice serves
llama3.2-1b: ``configs`` -> ``models.zoo.build`` -> ``serve.lm.ServeEngine``,
with prefill attention in a hand-written CUDA kernel
(``kernels.flash_attention``, source ``csrc/flash_attention.cu``). The
second is the predicate read path: the storage engine (``core``, ``scan``,
``obs``) under ``dataset.dataset(p).select(...).where(...)``, with the range
filter in a hand-written CUDA kernel (``kernels.filter``, source
``csrc/filter.cu``).

Every entry point takes a ``device``. The default is ``"cuda"``, and where
CUDA is absent the call raises: nothing falls back to the CPU unless the
caller asks for ``"cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``: ``cuda`` when None; raises if the
    device asked for is a CUDA device and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
