"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), the rates every
roofline share and utilization of this benchmark divides by.

NVIDIA's H100 data sheet, dense rates without sparsity, at the card's full
power limit of 700 W: a card set below it runs slower under load, so each
run prints the card's power limit beside its numbers.
"""

HBM_BYTES_PER_S = 3.35e12          # device memory bandwidth
BF16_FLOPS_PER_S = 989e12          # tensor cores, bf16 and fp16, dense
TF32_FLOPS_PER_S = 495e12          # tensor cores, TF32, dense
F32_FLOPS_PER_S = 67e12            # CUDA cores, float32
MEMORY_BYTES = 80e9                # device memory
