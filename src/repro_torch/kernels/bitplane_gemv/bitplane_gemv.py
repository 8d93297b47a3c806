"""Exact digit-plane gemv (B3): the CUDA kernel and its plain twin.

TPU-native in the JAX package, Hopper-native here: the form of the paper's
bit-serial multiplier (Sec. III) over a fixed matrix decomposed offline
into signed digit planes ``d_w in {-1, 0, 1}`` (PN or CSD):

    y = x @ V  =  sum_w  (x @ d_w) << w        (exact, int32)

Planes whose ``plane_mask`` flag is False (all zero in the whole matrix)
are never read — the analogue of the paper's constant propagation.  A CUDA
tensor goes through the kernel (``csrc/bitplane_gemv.cu``) or raises; a
CPU tensor takes :func:`bitplane_gemv_plain`.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch import obs
from repro_torch.core.sparse import int_matmul_exact
from repro_torch.kernels import _launch
from repro_torch.kernels._build import CudaLibrary, check

__all__ = ["LIBRARY", "bitplane_gemv", "bitplane_gemv_plain", "cluster_split"]

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "bitplane_gemv.cu",
    {"bitplane_gemv": [
        _I, _P, _I, _I, _I,   # x_is_int8, x, ld_x, batch, rows
        _P, _I, _I, _I, _I,   # digits, rows_d, cols, width, plane_mask
        _P, _I,               # y, ld_y
        _I, _I, _I,           # b_tile, split, part_rows
        _P]},                 # stream
    headers=(_launch.COMMON_HEADER,))

_SLICE = 32                   # output columns per thread block
_MAX_PLANES = 16
_MAX_CLUSTER = 8


def _kept(plane_mask, width: int) -> tuple:
    if plane_mask is None:
        return (True,) * width
    if len(plane_mask) != width:
        raise ValueError(f"plane_mask has {len(plane_mask)} flags for "
                         f"{width} planes")
    return tuple(bool(m) for m in plane_mask)


def _check_operands(x: torch.Tensor, digits: torch.Tensor) -> None:
    if x.dim() != 2 or digits.dim() != 3:
        raise ValueError(f"expected x (B, R) and digits (W, R, C), got "
                         f"{tuple(x.shape)} and {tuple(digits.shape)}")
    if x.dtype not in (torch.int8, torch.int32):
        raise TypeError(f"x must be int8 or int32, got {x.dtype}")
    if digits.dtype != torch.int8:
        raise TypeError(f"digits must be int8, got {digits.dtype}")
    if x.shape[1] > digits.shape[1]:
        raise ValueError(f"x has {x.shape[1]} columns, digits only "
                         f"{digits.shape[1]} rows")


def bitplane_gemv_plain(x: torch.Tensor, digits: torch.Tensor,
                        plane_mask: tuple | None = None) -> torch.Tensor:
    """Plain twin of :func:`bitplane_gemv`: one exact int32 product per
    kept plane, shifted and summed in int32.  Digit rows past ``x``'s
    columns are ignored (as if ``x`` were zero-padded)."""
    _check_operands(x, digits)
    kept = _kept(plane_mask, digits.shape[0])
    d = digits[:, : x.shape[1]]
    y = torch.zeros((x.shape[0], digits.shape[2]), dtype=torch.int32,
                    device=x.device)
    for w, keep in enumerate(kept):
        if keep:
            y = y + (int_matmul_exact(x, d[w]) << w)
    return y


def cluster_split(rows: int, n_slices: int, batch_tiles: int,
                  n_sms: int) -> int:
    """Thread blocks of one cluster that split the rows of a column slice:
    as many as fit the SMs in one wave, at most 8, each with >= 32 rows."""
    want = n_sms // max(1, n_slices * batch_tiles)
    return max(1, min(_MAX_CLUSTER, want, -(-rows // 32)))


def bitplane_gemv(x: torch.Tensor, digits: torch.Tensor, *,
                  plane_mask: tuple | None = None) -> torch.Tensor:
    """B3: ``y[b, c] = sum_r x[b, r] * V[r, c]`` through digit planes.

    Args:
        x: (B, R) int8 or int32 activations (unit stride over R).
        digits: (W, Rd, C) int8 planes in {-1, 0, 1}, ``Rd >= R``
            (rows past R are ignored), V = sum 2^w digits[w]; contiguous,
            C a multiple of 4 for the kernel.
        plane_mask: per-plane keep flags (None keeps every plane).

    Returns:
        (B, C) int32: the product modulo 2^32, as int32 arithmetic gives
        it (exact for int8 x while 128 * 255 * R < 2^31).
    """
    _check_operands(x, digits)
    if not _launch.on_cuda(x, digits):
        return bitplane_gemv_plain(x, digits, plane_mask)
    kept = _kept(plane_mask, digits.shape[0])
    width, rows_d, cols = digits.shape
    b, rows = x.shape
    if width > _MAX_PLANES:
        raise ValueError(f"{width} digit planes > {_MAX_PLANES}")
    if (not digits.is_contiguous() or cols % 4
            or digits.data_ptr() % 4 or not _launch.unit_stride(x, 1)):
        raise ValueError("bitplane_gemv needs contiguous digits with C a "
                         "multiple of 4 and x with unit stride over R")
    bt = _launch.batch_tile(b)
    n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    split = cluster_split(rows, -(-cols // _SLICE), -(-b // bt), n_sms)
    part_rows = -(-rows // split)
    _launch.check_smem(4 * (bt * part_rows + (_launch.WARPS + 1) * bt * 4
                            * _launch.COLS), "bitplane_gemv")
    y = torch.empty((b, cols), dtype=torch.int32, device=x.device)
    mask = sum(1 << w for w, keep in enumerate(kept) if keep)
    rc = LIBRARY.load().bitplane_gemv(
        int(x.dtype == torch.int8), x.data_ptr(), x.stride(0), b, rows,
        digits.data_ptr(), rows_d, cols, width, mask, y.data_ptr(),
        y.stride(0), bt, split, part_rows, _launch.stream(x.device))
    check(rc, "bitplane_gemv")
    bitplane_gemv.launches += 1
    obs.inc("kernel_launches_total", kernel="bitplane_gemv")
    return y


bitplane_gemv.launches = 0
