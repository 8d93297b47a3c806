"""Digit-plane gemv: the CUDA kernel (B3) and its plain PyTorch twin."""
