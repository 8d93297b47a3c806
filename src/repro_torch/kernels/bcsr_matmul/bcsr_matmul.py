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
x's type.  The kernel (``csrc/bcsr_matmul.cu``) reads each thread block's
columns of its tiles as one contiguous share, packed once, offline
(:func:`pack_tiles`), and stages only the x rows its own tiles need.  A
CUDA tensor goes through the kernel or raises; a CPU tensor takes
:func:`bcsr_matmul_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.sparse import int_matmul_exact
from repro_torch.kernels import _launch
from repro_torch.kernels._build import CudaLibrary, check

__all__ = ["LIBRARY", "BcsrGrid", "PackedTiles", "bcsr_grid", "bcsr_matmul",
           "bcsr_matmul_plain", "out_dtype", "pack_share_blob", "pack_tiles"]

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "bcsr_matmul.cu",
    {"bcsr_matmul": [
        _I, _P, _I, _I, _I,       # x_kind, x, ld_x, batch, rows
        _P, _P, _P,               # blob, meta, tile_rows
        _I, _I, _I, _I,           # bk, cw, slices, parts
        _I, _I,                   # max_tiles, x_vec
        _P, _I, _I,               # y, ld_y, b_tile
        _I, _I,                   # n_blocks, smem
        _P]},                     # stream
    headers=(_launch.COMMON_HEADER, _launch.HOPPER_HEADER))

# The kernel's geometry (csrc/bcsr_matmul.cu).
_THREADS = 256
_BAR_BYTES = 16               # the share's mbarrier
_MAX_CLUSTER = 8              # the portable cluster size
_MAX_TILES = 64               # tiles of one block's share
_SLICE_COLS = (128, 64, 32, 16, 8)   # column-slice widths, widest first

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


@dataclasses.dataclass(frozen=True)
class BcsrGrid:
    """The launch geometry of one tile layout on one device.

    Block ``(ci, sl, p)`` (index ``(ci * slices + sl) * parts + p``) owns
    columns ``sl * cw .. + cw`` of column block ``ci`` and part ``p`` of
    its run of tiles (``parts`` parts of at most ``max_tiles`` tiles); the
    ``parts`` blocks of a slice form a cluster and add their partial sums
    in rank order.
    """

    bk: int
    n_col_blocks: int
    cw: int
    slices: int
    parts: int
    max_tiles: int

    @property
    def n_blocks(self) -> int:
        return self.n_col_blocks * self.slices * self.parts

    def smem(self, b_tile: int) -> int:
        """Dynamic shared memory of one block at ``b_tile`` batch rows: the
        mbarrier, the share, its x rows (converted to 4-byte float or
        int), the partial sums of the row-lane groups (the row lanes that
        share a warp form one group), the inbox for the cluster's sums of
        this block's outputs and its tiles' row blocks."""
        rows = self.max_tiles * self.bk
        lanes = _THREADS // (self.cw // 4 * (b_tile // min(4, b_tile)))
        groups = lanes // min(lanes, 32 // min(self.cw // 4, 8))
        inbox = self.parts * (-(-b_tile * self.cw // self.parts) + 3 & ~3)
        return (_BAR_BYTES + rows * self.cw * 4 + rows * b_tile * 4
                + (groups * b_tile * self.cw + inbox) * 4
                + 4 * self.max_tiles)


def bcsr_grid(col_ptr, bk: int, n_sms: int) -> BcsrGrid:
    """The grid for a layout with run offsets ``col_ptr`` and block ``bk``
    on ``n_sms`` SMs: each run split into up to 8 parts (a cluster), and
    the widest column slices (the fewest copies of each x row) that still
    keep a quarter of the SMs busy.  At LARGE_1024 on the H100 64 blocks
    of 128 columns measured faster than 128 of 64 at batch 16 and 1
    (``tools/probe_fixed_kernels.py``)."""
    runs = np.diff(np.asarray(col_ptr))
    ncb, longest = len(runs), int(runs.max())
    parts = min(_MAX_CLUSTER, longest)
    widths = [cw for cw in _SLICE_COLS if bk % cw == 0]
    if not widths:
        raise ValueError(f"bcsr_matmul needs a block that is a multiple of "
                         f"8, got {bk}")
    cw = next((w for w in widths if ncb * (bk // w) * parts >= n_sms // 4),
              widths[-1])
    max_tiles = -(-longest // parts)
    if max_tiles > _MAX_TILES:
        raise ValueError(f"bcsr_matmul: a run of {longest} tiles needs "
                         f"{max_tiles} tiles per block > {_MAX_TILES}")
    return BcsrGrid(bk=bk, n_col_blocks=ncb, cw=cw, slices=bk // cw,
                    parts=parts, max_tiles=max_tiles)


def pack_share_blob(tiles: np.ndarray, col_ptr, tile_rows, grid: BcsrGrid):
    """Every block's share, contiguous: its tiles' ``cw`` columns as
    ``[tile][row][column]`` float32.  Returns the blob (uint8) and one
    ``(byte offset, tiles, first tile, first tile's row block)`` int32 row
    per block."""
    cp = np.asarray(col_ptr)
    cw, parts = grid.cw, grid.parts
    shares, meta, offset = [], [], 0
    for ci in range(grid.n_col_blocks):
        lo, hi = int(cp[ci]), int(cp[ci + 1])
        per = -(-(hi - lo) // parts)
        for sl in range(grid.slices):
            for p in range(parts):
                t0, t1 = min(hi, lo + p * per), min(hi, lo + (p + 1) * per)
                share = np.ascontiguousarray(
                    tiles[t0:t1, :, sl * cw:(sl + 1) * cw], np.float32)
                meta.append((offset, t1 - t0, t0,
                             int(tile_rows[t0]) if t1 > t0 else 0))
                shares.append(share.view(np.uint8).reshape(-1))
                offset += share.nbytes
    blob = np.concatenate(shares) if offset else np.zeros(16, np.uint8)
    return blob, np.asarray(meta, np.int32).reshape(-1, 4)


@dataclasses.dataclass(frozen=True)
class PackedTiles:
    """One tile layout packed on a CUDA device: the grid, the blob of
    shares, its per-block rows and the tiles' row blocks, the rows of M
    and the kernel's entry point."""

    grid: BcsrGrid
    rows_pad: int
    blob: torch.Tensor
    meta: torch.Tensor
    tile_rows: torch.Tensor
    fn: object = dataclasses.field(repr=False, compare=False)
    smem: dict = dataclasses.field(default_factory=dict, compare=False,
                                   repr=False)


def pack_tiles(tiles, col_ptr, tile_rows, rows_pad: int, device
               ) -> PackedTiles:
    """Pack (n, bk, bk) ``tiles`` sorted by (col, row), with run offsets
    ``col_ptr`` and row blocks ``tile_rows``, for the kernel on a CUDA
    ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"pack_tiles packs for a CUDA device, not {device}")
    host = lambda t: np.asarray(t.cpu() if torch.is_tensor(t) else t)  # noqa: E731
    tiles, cp, rows = host(tiles), host(col_ptr), host(tile_rows)
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = bcsr_grid(cp, tiles.shape[1], n_sms)
    blob, meta = pack_share_blob(tiles, cp, rows, grid)
    return PackedTiles(
        grid=grid, rows_pad=rows_pad,
        blob=torch.as_tensor(blob, device=device),
        meta=torch.as_tensor(meta, device=device),
        tile_rows=torch.as_tensor(rows.astype(np.int32), device=device),
        fn=LIBRARY.load().bcsr_matmul)


def _launch_packed(x: torch.Tensor, pk: PackedTiles) -> torch.Tensor:
    out = out_dtype(x.dtype)
    _launch.same_device(pk.blob.device, x)
    grid = pk.grid
    if x.dim() != 2 or x.shape[1] > pk.rows_pad:
        raise ValueError(f"x must be (B, R <= {pk.rows_pad}), got "
                         f"{tuple(x.shape)}")
    if not _launch.unit_stride(x, 1):
        raise ValueError("bcsr_matmul needs x with unit stride over R")
    b, rows = x.shape
    bt = _launch.batch_tile(b)
    if bt not in pk.smem:
        smem = grid.smem(bt)
        _launch.check_smem(smem, "bcsr_matmul")
        pk.smem[bt] = smem
    esize = x.element_size()
    x_vec = (x.data_ptr() % 16 == 0 and (x.stride(0) * esize) % 16 == 0
             and (grid.bk * esize) % 16 == 0)
    y = torch.empty((b, grid.n_col_blocks * grid.bk), dtype=out,
                    device=x.device)
    if b == 0:
        return y
    rc = pk.fn(
        _KIND[x.dtype], x.data_ptr(), x.stride(0), b, rows,
        pk.blob.data_ptr(), pk.meta.data_ptr(), pk.tile_rows.data_ptr(),
        grid.bk, grid.cw, grid.slices, grid.parts, grid.max_tiles,
        int(x_vec), y.data_ptr(), y.stride(0), bt,
        grid.n_blocks, pk.smem[bt], _launch.stream(x.device))
    check(rc, "bcsr_matmul")
    bcsr_matmul.launches += 1
    obs.inc("kernel_launches_total", kernel="bcsr_matmul")
    return y


def bcsr_matmul(x: torch.Tensor, tiles, col_ptr: torch.Tensor | None = None,
                tile_rows: torch.Tensor | None = None,
                rows_pad: int | None = None) -> torch.Tensor:
    """B4: block-sparse product over a static, (col, row)-sorted tile list.

    Args:
        x: (B, R) float32, bfloat16, int8 or int32 activations (unit
            stride over R), ``R <= rows_pad``; columns past R read as 0.
        tiles: (n_tiles, bk, bk) float32, sorted by (col, row); or, for a
            CUDA x, the :class:`PackedTiles` of :func:`pack_tiles` alone
            (what :class:`~repro_torch.kernels.bcsr_matmul.ops.BcsrMatmul`
            passes: a CUDA x with raw tiles packs them for this one call).
        col_ptr: (n_col_blocks + 1,) int32 run offsets per column block
            (every run non-empty); tile_rows: (n_tiles,) int32 row blocks.
        rows_pad: rows of M in whole blocks.

    Returns:
        (B, n_col_blocks * bk): float32 for float x, int32 for integer x.
    """
    if isinstance(tiles, PackedTiles):
        return _launch_packed(x, tiles)
    _check_operands(x, tiles, col_ptr, tile_rows, rows_pad)
    if not _launch.on_cuda(x, tiles, col_ptr, tile_rows):
        return bcsr_matmul_plain(x, tiles, col_ptr, tile_rows, rows_pad)
    _launch.check_f32(tiles)
    if col_ptr.dtype != torch.int32 or tile_rows.dtype != torch.int32:
        raise TypeError("col_ptr and tile_rows must be int32")
    return _launch_packed(x, pack_tiles(tiles, col_ptr, tile_rows, rows_pad,
                                        x.device))


bcsr_matmul.launches = 0
