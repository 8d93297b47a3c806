"""Fused dense reservoir step: the CUDA kernel (B5) and its plain PyTorch
twin."""
