"""Fused reservoir rollout: CUDA kernels (B1 generic, B2 specialized) and
their plain PyTorch twins."""
