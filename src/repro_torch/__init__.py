"""PyTorch and CUDA port of the ``repro`` package, for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it and keeps its own copy of what it needs. The first slice serves
llama3.2-1b: ``configs`` -> ``models.zoo.build`` -> ``serve.lm.ServeEngine``,
with prefill attention in a hand-written CUDA kernel
(``kernels.flash_attention``, source ``csrc/flash_attention.cu``). The
second is the predicate read path: the storage engine (``core``, ``scan``,
``obs``) under ``dataset.dataset(p).select(...).where(...)``, with the range
filter in a hand-written CUDA kernel (``kernels.filter``, source
``csrc/filter.cu``). The third is the quantized-column read: the same path's
dequantize of BF16 and affine-integer columns in a hand-written CUDA kernel
(``kernels.dequant``, ``csrc/dequant.cu``), and the BP32 unpack as an entry
point of its own, ``kernels.bitunpack.{pack_bp32, bitunpack}``
(``csrc/bitunpack.cu``). The fourth adds what is built on that read:
deletion compliance (``core.deletion``, ``Dataset.delete_where``), the write
sink (``dataset.sink``, ``Dataset.write_to``), quality-aware multimodal
reads (``core.multimodal``), trace export (``obs.export``, ``obs.expose``)
and the training-data loader (``data.loader.BullionLoader``), all through
the same filter and dequant kernels.

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
