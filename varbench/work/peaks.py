"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 34e12  # FP64 outside the tensor cores
F32_FLOP_PER_S = 67e12  # FP32 outside the tensor cores
