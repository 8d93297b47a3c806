"""Block-sparse (BCSR) matmul with static culling (B4): the CUDA kernel and
its plain twin.

``y = x @ M`` where M's nonzero-block structure is *fixed* (the paper's
setting: the reservoir matrix never changes).  Only the nonzero tiles are
stored and walked — zero blocks are culled before the kernel is launched,
as the paper's synthesis flow culls adders for zero weights.  The tiles
are sorted by (col, row) and every empty output column block holds one
zero tile (:class:`repro_torch.plan.BcsrLayout`), so column block ``c``'s
tiles are the contiguous run ``col_ptr[c]:col_ptr[c + 1]``.

Types follow the JAX kernel, which casts each tile to x's type first:
float32 and bfloat16 x give float32 y (a bf16 x multiplies bf16-rounded
tiles); int8 and int32 x give int32 y over tiles truncated toward zero to
x's type.  A CUDA tensor goes through the kernel (``csrc/bcsr_matmul.cu``)
or raises; a CPU tensor takes :func:`bcsr_matmul_plain`.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch import obs
from repro_torch.core.sparse import int_matmul_exact
from repro_torch.kernels import _launch
from repro_torch.kernels._build import CudaLibrary, check

__all__ = ["LIBRARY", "bcsr_matmul", "bcsr_matmul_plain", "out_dtype"]

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "bcsr_matmul.cu",
    {"bcsr_matmul": [
        _I, _P, _I, _I, _I,   # x_kind, x, ld_x, batch, rows
        _P, _P, _P,           # tiles, col_ptr, tile_rows
        _I, _I, _I,           # bk, rows_pad, n_col_blocks
        _P, _I, _I,           # y, ld_y, b_tile
        _P]},                 # stream
    headers=(_launch.COMMON_HEADER,))

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int32: 3}


def out_dtype(x_dtype: torch.dtype) -> torch.dtype:
    """float32 for float32/bfloat16 x, int32 for int8/int32 x."""
    if x_dtype not in _KIND:
        raise TypeError(f"x must be float32, bfloat16, int8 or int32, got "
                        f"{x_dtype}")
    return torch.float32 if x_dtype.is_floating_point else torch.int32


def _check_operands(x, tiles, col_ptr, tile_rows, rows_pad):
    out_dtype(x.dtype)
    if x.dim() != 2 or tiles.dim() != 3 or tiles.shape[1] != tiles.shape[2]:
        raise ValueError(f"expected x (B, R) and tiles (n, bk, bk), got "
                         f"{tuple(x.shape)} and {tuple(tiles.shape)}")
    if x.shape[1] > rows_pad or rows_pad % tiles.shape[1]:
        raise ValueError(f"x has {x.shape[1]} columns; rows_pad {rows_pad} "
                         f"must cover them in whole blocks of "
                         f"{tiles.shape[1]}")
    if col_ptr.dim() != 1 or tile_rows.shape != (tiles.shape[0],):
        raise ValueError("col_ptr must be (n_col_blocks + 1,) and tile_rows "
                         "(n_tiles,)")


def bcsr_matmul_plain(x: torch.Tensor, tiles: torch.Tensor,
                      col_ptr: torch.Tensor, tile_rows: torch.Tensor,
                      rows_pad: int) -> torch.Tensor:
    """Plain twin of :func:`bcsr_matmul`: each column block's tile
    products summed in tile order (exact integer products for integer
    x)."""
    _check_operands(x, tiles, col_ptr, tile_rows, rows_pad)
    b, r = x.shape
    bk = tiles.shape[1]
    cp, rows = col_ptr.tolist(), tile_rows.tolist()
    dtype = out_dtype(x.dtype)
    xp = torch.zeros((b, rows_pad), dtype=x.dtype, device=x.device)
    xp[:, :r] = x
    y = torch.zeros((b, (len(cp) - 1) * bk), dtype=dtype, device=x.device)
    for ci in range(len(cp) - 1):
        acc = None
        for t in range(cp[ci], cp[ci + 1]):
            xs = xp[:, rows[t] * bk:(rows[t] + 1) * bk]
            if x.dtype == torch.float32:
                prod = xs @ tiles[t]
            elif x.dtype == torch.bfloat16:
                prod = xs.float() @ tiles[t].to(torch.bfloat16).float()
            else:
                prod = int_matmul_exact(
                    xs, tiles[t].to(torch.int32).to(x.dtype))
            acc = prod if acc is None else acc + prod
        if acc is not None:
            y[:, ci * bk:(ci + 1) * bk] = acc
    return y


def bcsr_matmul(x: torch.Tensor, tiles: torch.Tensor, col_ptr: torch.Tensor,
                tile_rows: torch.Tensor, rows_pad: int) -> torch.Tensor:
    """B4: block-sparse product over a static, (col, row)-sorted tile list.

    Args:
        x: (B, R) float32, bfloat16, int8 or int32 activations (unit
            stride over R), ``R <= rows_pad``; columns past R read as 0.
        tiles: (n_tiles, bk, bk) float32, sorted by (col, row).
        col_ptr: (n_col_blocks + 1,) int32 run offsets per column block
            (every run non-empty); tile_rows: (n_tiles,) int32 row blocks.
        rows_pad: rows of M in whole blocks.

    Returns:
        (B, n_col_blocks * bk): float32 for float x, int32 for integer x.
    """
    _check_operands(x, tiles, col_ptr, tile_rows, rows_pad)
    if not _launch.on_cuda(x, tiles, col_ptr, tile_rows):
        return bcsr_matmul_plain(x, tiles, col_ptr, tile_rows, rows_pad)
    _launch.check_f32(tiles)
    if col_ptr.dtype != torch.int32 or tile_rows.dtype != torch.int32:
        raise TypeError("col_ptr and tile_rows must be int32")
    bk = tiles.shape[1]
    if (bk % _launch.COLS or not tiles.is_contiguous()
            or not col_ptr.is_contiguous() or not tile_rows.is_contiguous()
            or not _launch.unit_stride(x, 1)):
        raise ValueError(f"bcsr_matmul needs contiguous tables, a block "
                         f"that is a multiple of {_launch.COLS} and x with "
                         "unit stride over R")
    b, rows = x.shape
    n_cb = col_ptr.shape[0] - 1
    bt = _launch.batch_tile(b)
    _launch.check_smem(4 * (bt * rows_pad + (_launch.WARPS + 1) * bt
                            * _launch.COLS), "bcsr_matmul")
    y = torch.empty((b, n_cb * bk), dtype=out_dtype(x.dtype),
                    device=x.device)
    rc = LIBRARY.load().bcsr_matmul(
        _KIND[x.dtype], x.data_ptr(), x.stride(0), b, rows, tiles.data_ptr(),
        col_ptr.data_ptr(), tile_rows.data_ptr(), bk, rows_pad, n_cb,
        y.data_ptr(), y.stride(0), bt, _launch.stream(x.device))
    check(rc, "bcsr_matmul")
    bcsr_matmul.launches += 1
    obs.inc("kernel_launches_total", kernel="bcsr_matmul")
    return y


bcsr_matmul.launches = 0
