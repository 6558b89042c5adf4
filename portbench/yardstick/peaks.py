"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12        # outside the tensor cores
INT8_OP_S = 1979e12
HBM_BYTES_S = 3.35e12

# the rate a sampler's field products run at, by the coupling's stored type:
# the gather sums in f32 lanes whatever the type it reads
SWEEP_OP_S = {"float32": F32_FLOP_S, "bfloat16": F32_FLOP_S, "int8": F32_FLOP_S}
COUPLING_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
