"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)."""

BF16_FLOPS = 989e12        # FLOP/s, bfloat16 tensor cores, no sparsity
HBM_BYTES = 3.35e12        # bytes/s
