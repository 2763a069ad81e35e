"""Hand-written Hopper kernels of the port, each beside its plain version.

  bitunpack       — BP32 bit-planar unpack (``csrc/bitunpack.cu``; replaces
                    ``repro/kernels/bitunpack/kernel.py`` ``bitunpack_pallas``)
  dequant         — fused per-column dequantize + cast, the read path's
                    dequantize step (``csrc/dequant.cu``; replaces
                    ``repro/kernels/dequant/kernel.py`` ``dequant_pallas``)
  filter          — conjunctive range filter for predicate pushdown
                    (``csrc/filter.cu``; replaces ``range_mask_pallas``)
  flash_attention — blocked online-softmax attention for prefill
                    (``csrc/flash_attention.cu``; replaces
                    ``flash_attention_pallas``)

Each ``<kernel>/`` holds the binding of its CUDA source (``kernel.py``), the
public wrapper with its launch count (``ops.py``) and the plain PyTorch
version (``ref.py``). ``_build`` compiles the sources with ``nvcc`` at first
use; nothing here builds or touches CUDA on import.
"""

__all__ = ["bitunpack", "dequant", "filter", "flash_attention"]
