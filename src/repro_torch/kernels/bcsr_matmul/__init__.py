"""Block-sparse (BCSR) matmul: the CUDA kernel (B4) and its plain PyTorch
twin."""
