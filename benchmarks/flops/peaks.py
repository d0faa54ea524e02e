"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at the
card's full 700 W: bf16 products on the tensor cores, and HBM3."""
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
