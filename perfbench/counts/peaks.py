"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W limit), frozen for the benchmark's roofline and utilisation
shares. Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``,
``INT32_OPS_PER_S``, lines 239-240 at the benchmark's first version) and the
data sheet's bfloat16 tensor-core rate."""

HBM_BYTES_PER_S = 3.35e12
# int32 operations a second outside the tensor cores: 64 INT32 lanes per SM
# against 128 FP32 lanes, a quarter of the 67 TFLOP/s float32 rate (which
# counts an FMA as two operations)
INT32_OPS_PER_S = 67e12 / 4
BF16_DENSE_FLOPS = 989e12
