"""Fused reservoir state update (B5): the CUDA kernel and its plain twin.

One step of paper Eq. 1 for a batch of reservoir states over a dense
reservoir matrix:

    x' = (1 - leak) * x + leak * tanh(u @ W_in + x @ W)

The kernel (``csrc/reservoir_step.cu``) fuses both products with the
activation and the leak, so the pre-activation never goes through device
memory — the recurrent latency path the paper optimizes.  A CUDA tensor
goes through the kernel or raises; a CPU tensor takes
:func:`reservoir_step_plain`.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch import obs
from repro_torch.kernels import _launch
from repro_torch.kernels._build import CudaLibrary, check

__all__ = ["LIBRARY", "reservoir_step", "reservoir_step_plain"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "reservoir_step.cu",
    {"reservoir_step": [
        _P, _I, _I, _I,       # x, ld_x, batch, dim
        _P, _P, _I, _P, _I,   # w, u, ld_u, w_in, in_dim
        _F, _F,               # one_minus_leak, leak
        _P, _I, _I,           # out, ld_out, b_tile
        _P]},                 # stream
    headers=(_launch.COMMON_HEADER,))


def _check_operands(x, w, u, w_in, out):
    b, dim = x.shape
    if w.shape != (dim, dim) or u.dim() != 2 or u.shape[0] != b:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)}")
    if w_in.shape != (u.shape[1], dim):
        raise ValueError(f"w_in must be ({u.shape[1]}, {dim}), got "
                         f"{tuple(w_in.shape)}")
    if out is not None and out.shape != (b, dim):
        raise ValueError(f"out must be ({b}, {dim}), got {tuple(out.shape)}")
    if out is not None and _launch.overlaps(out, x):
        raise ValueError("out must not overlap x")


def reservoir_step_plain(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                         w_in: torch.Tensor, *, leak: float = 1.0,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of :func:`reservoir_step`."""
    _check_operands(x, w, u, w_in, out)
    nxt = (1.0 - leak) * x + leak * torch.tanh(u @ w_in + x @ w)
    if out is None:
        return nxt
    return out.copy_(nxt)


def reservoir_step(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                   w_in: torch.Tensor, *, leak: float = 1.0,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """B5: one fused ESN step for a state batch.

    Args:
        x: (B, R) float32 current states (unit stride over R).
        w: (R, R) float32 reservoir matrix, contiguous.
        u: (B, I) float32 inputs (unit stride over I).
        w_in: (I, R) float32 input weights, contiguous.
        leak: Eq. 1's leak rate.
        out: optional (B, R) buffer (unit stride over R, not overlapping
            x) that receives the next states in place.

    Returns:
        (B, R) next states, float32 (``out`` when given).
    """
    _check_operands(x, w, u, w_in, out)
    if not _launch.on_cuda(x, w, u, w_in, out):
        return reservoir_step_plain(x, w, u, w_in, leak=leak, out=out)
    _launch.check_f32(x, w, u, w_in, out)
    b, dim = x.shape
    if out is None:
        out = torch.empty((b, dim), device=x.device)
    if (not w.is_contiguous() or not w_in.is_contiguous()
            or not all(_launch.unit_stride(t, 1) for t in (x, u, out))):
        raise ValueError("reservoir_step needs contiguous w and w_in and "
                         "x, u, out with unit stride over their last dim")
    bt = _launch.batch_tile(b)
    _launch.check_smem(4 * (bt * (-(-dim // 4) * 4) + (_launch.WARPS + 1)
                            * bt * _launch.COLS), "reservoir_step")
    rc = LIBRARY.load().reservoir_step(
        x.data_ptr(), x.stride(0), b, dim, w.data_ptr(), u.data_ptr(),
        u.stride(0), w_in.data_ptr(), u.shape[1], 1.0 - leak, leak,
        out.data_ptr(), out.stride(0), bt, _launch.stream(x.device))
    check(rc, "reservoir_step")
    reservoir_step.launches += 1
    obs.inc("kernel_launches_total", kernel="reservoir_step")
    return out


reservoir_step.launches = 0
