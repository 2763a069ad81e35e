"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W), the yardstick of every roofline share and MFU here.
Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S`` and the rates of its
bounds), frozen with the benchmark."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "float32": 67e12,        # CUDA cores, TF32 off
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
}
