"""What every kernel wrapper checks before a launch, and the launch
geometry the fixed-matrix kernels share (``common.cuh``).

A wrapper takes the plain twin for CPU operands and the kernel for CUDA
ones; anything else, or operands on different devices, raises.
"""

from __future__ import annotations

import pathlib

import torch

__all__ = ["COMMON_HEADER", "MAX_SMEM", "WARPS", "COLS", "batch_tile",
           "check_f32", "check_smem", "on_cuda", "overlaps", "require_cuda",
           "same_device", "stream", "unit_stride"]

COMMON_HEADER = pathlib.Path(__file__).resolve().parent / "common.cuh"
COLS = 8                  # threadIdx.x of a fixed-matrix thread block
WARPS = 8                 # 8 x 32 threads
MAX_SMEM = 227 * 1024     # opt-in dynamic shared memory per block (H100)


def require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {t.device}")


def same_device(dev: torch.device, *tensors) -> None:
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} "
                             f"vs {dev}")


def on_cuda(x: torch.Tensor, *others) -> bool:
    """False for CPU operands (take the twin), True for CUDA ones (launch
    the kernel); raises on mixed or other devices."""
    same_device(x.device, *others)
    if x.device.type == "cpu":
        return False
    require_cuda(x)
    return True


def check_f32(*tensors) -> None:
    for t in tensors:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def unit_stride(t: torch.Tensor, dim: int) -> bool:
    return t.shape[dim] == 1 or t.stride(dim) == 1


def _byte_span(t: torch.Tensor) -> tuple[int, int]:
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when the byte ranges the two tensors span intersect (a view
    at an offset of the same storage included)."""
    if a.numel() == 0 or b.numel() == 0 or a.device != b.device:
        return False
    (a_lo, a_hi), (b_lo, b_hi) = _byte_span(a), _byte_span(b)
    return a_lo < b_hi and b_lo < a_hi


def batch_tile(batch: int) -> int:
    """Batch rows per thread block of a fixed-matrix kernel: the power of
    two that covers ``batch``, at most 16 (the kernels' instantiations)."""
    return min(16, 1 << max(0, batch - 1).bit_length())


def check_smem(nbytes: int, what: str) -> None:
    if nbytes > MAX_SMEM:
        raise ValueError(f"{what} needs {nbytes} B of shared memory per "
                         f"block > {MAX_SMEM}")
