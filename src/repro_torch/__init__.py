"""PyTorch/CUDA port of the spatial sparse-matrix reservoir system.

Mirrors the JAX package ``repro`` module for module (``core``, ``plan``,
``kernels``, ``serve``, ``obs``, ``runtime``); the kernels on the serving
path are hand-written CUDA C++ for Hopper (sm_90a), each with a plain
PyTorch twin used on the CPU.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
