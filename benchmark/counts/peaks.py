"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
no sparsity, at the 700 W limit)."""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

FLOPS = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}
