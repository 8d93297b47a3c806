"""Exact digit-plane gemv (B3): the CUDA kernel and its plain twin.

TPU-native in the JAX package, Hopper-native here: the form of the paper's
bit-serial multiplier (Sec. III) over a fixed matrix decomposed offline
into signed digit planes ``d_w in {-1, 0, 1}`` (PN or CSD):

    y = x @ V  =  sum_w  (x @ d_w) << w        (exact, int32)

Planes whose ``plane_mask`` flag is False (all zero in the whole matrix)
are never read — the analogue of the paper's constant propagation.  The
kernel (``csrc/bitplane_gemv.cu``) multiplies int8 x on the tensor cores
(one ``mma.sync.m16n8k32`` per kept plane and 32-row chunk), so the kept
planes are packed once, offline, into per-thread-block shares in the
MMA's B-fragment order (:func:`pack_planes`).  A CUDA tensor goes through
the kernel or raises; a CPU tensor takes :func:`bitplane_gemv_plain`.
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

__all__ = ["LIBRARY", "PackedPlanes", "PlaneGrid", "bitplane_gemv",
           "bitplane_gemv_plain", "pack_blob", "pack_planes", "plane_grid"]

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "bitplane_gemv.cu",
    {"bitplane_gemv": [
        _I, _P, _I, _I, _I,   # x_is_int8, x, ld_x, batch, rows
        _P, _I, _I, _I,       # blob, cols, groups, n_kept
        ctypes.c_ulonglong,   # shifts
        _I, _I, _I, _I,       # kch, sc, n_stages, n_buf
        _I, _I, _I, _I,       # share_bytes, stage_bytes, x_stride, x_vec
        _P, _I,               # y, ld_y
        _I, _I,               # n_blocks, smem
        _P]},                 # stream
    headers=(_launch.COMMON_HEADER, _launch.HOPPER_HEADER))

# The kernel's geometry (csrc/bitplane_gemv.cu).
_MAX_PLANES = 16
_ROWS = 16                    # batch rows per tile: the MMA's M
_COLS = 8                     # output columns per MMA: N
_DEPTH = 32                   # rows per MMA: K
_FRAG = 256                   # bytes of one B fragment
_MAX_BUFS = 16                # mbarriers at the head of shared memory
_STAGE = 16 * 1024            # target bytes of one bulk-copied stage


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
    _check_x(x)
    if digits.dtype != torch.int8:
        raise TypeError(f"digits must be int8, got {digits.dtype}")
    if x.shape[1] > digits.shape[1]:
        raise ValueError(f"x has {x.shape[1]} columns, digits only "
                         f"{digits.shape[1]} rows")


def _check_x(x: torch.Tensor) -> None:
    if x.dtype not in (torch.int8, torch.int32):
        raise TypeError(f"x must be int8 or int32, got {x.dtype}")


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


@dataclasses.dataclass(frozen=True)
class PlaneGrid:
    """Where the kept planes of one matrix go on the card.

    Block ``k`` owns ``groups`` 8-column groups for all ``kch`` 32-row
    chunks and all kept planes (``planes``: their plane indices, which are
    their shifts).  Its share is cut into ``n_stages`` stages of ``sc``
    chunks (the last may be shorter), each moved by one bulk copy.
    """

    rows: int
    cols: int
    planes: tuple
    groups: int
    n_blocks: int
    kch: int
    sc: int

    @property
    def n_stages(self) -> int:
        return -(-self.kch // self.sc)

    @property
    def unit_bytes(self) -> int:
        """One 32-row chunk of the block's columns over the kept planes."""
        return self.groups * len(self.planes) * _FRAG

    @property
    def stage_bytes(self) -> int:
        return self.sc * self.unit_bytes

    @property
    def share_bytes(self) -> int:
        return self.kch * self.unit_bytes

    @property
    def shifts(self) -> int:
        """Kept plane p's shift in bits 4 p .. 4 p + 3."""
        return sum(w << (4 * p) for p, w in enumerate(self.planes))

    def x_stride(self, x_int8: bool) -> int:
        """Elements per staged batch row: int8 rows padded by 16 bytes so
        the A-fragment loads fall in 32 distinct banks."""
        return self.kch * _DEPTH + (16 if x_int8 else 0)

    def smem(self, n_buf: int, x_int8: bool) -> int:
        """Dynamic shared memory of one block with ``n_buf`` stage
        buffers: the mbarriers, the buffers, one staged x tile and the 8
        warps' (16 x columns) uint32 partials."""
        return (8 * _MAX_BUFS + n_buf * self.stage_bytes
                + _ROWS * self.x_stride(x_int8) * (1 if x_int8 else 4)
                + _launch.WARPS * _ROWS * self.groups * _COLS * 4)

    def buffers(self, x_int8: bool) -> int:
        """Stage buffers per block: every stage (resident) when the share
        fits, else a ring of as many as fit; raises when not even two
        stages fit beside the x tile."""
        free = _launch.MAX_SMEM - self.smem(0, x_int8)
        if self.n_stages <= _MAX_BUFS and self.share_bytes <= free:
            return self.n_stages
        n_buf = min(_MAX_BUFS, free // self.stage_bytes)
        if n_buf < 2:
            raise ValueError(
                f"bitplane_gemv: a {self.rows}-row "
                f"{'int8' if x_int8 else 'int32'} x tile and two "
                f"{self.stage_bytes} B stages do not fit one block's "
                f"{_launch.MAX_SMEM} B of shared memory")
        return n_buf


def plane_grid(rows: int, cols: int, planes: tuple, n_sms: int
               ) -> PlaneGrid:
    """The grid for an (rows, cols) matrix with kept ``planes`` on
    ``n_sms`` SMs: the fewest 8-column groups per block that keep the
    grid within one wave; each share in one stage (one bulk copy) when it
    fits one block beside an int32 x tile, else in stages of about 16 KiB
    streamed through a ring (on the H100 every further copy of a share
    cost more than its overlap with the MMAs gained:
    ``tools/probe_fixed_kernels.py``)."""
    n_groups = -(-cols // _COLS)
    groups = -(-n_groups // n_sms)
    kch = -(-rows // _DEPTH)
    unit = groups * len(planes) * _FRAG
    grid = PlaneGrid(rows=rows, cols=cols, planes=tuple(planes),
                     groups=groups, n_blocks=-(-n_groups // groups),
                     kch=kch, sc=kch)
    if grid.smem(1, False) <= _launch.MAX_SMEM:
        return grid
    return dataclasses.replace(grid, sc=max(1, min(kch, _STAGE // unit)))


def pack_blob(digits: np.ndarray, grid: PlaneGrid) -> np.ndarray:
    """The kept planes of ``digits`` (W, R, C) as the blocks' shares.

    Per block, stage by stage; inside a stage 256-byte m16n8k32 B
    fragments in (group, chunk, plane) order; lane ``l``'s 8 bytes at
    ``8 l`` hold column ``l // 4``, rows ``4 (l % 4) + e`` and ``16 + 4
    (l % 4) + e`` (e < 4) of the chunk.  Rows and columns past the matrix
    are zero.
    """
    n_p, kch, nb, g = len(grid.planes), grid.kch, grid.n_blocks, grid.groups
    d = np.zeros((n_p, kch * _DEPTH, nb * g * _COLS), np.int8)
    d[:, :grid.rows, :grid.cols] = digits[list(grid.planes), :grid.rows]
    # (plane, chunk, half, tig, e, group, column) -> (group, chunk, plane,
    # column, tig, half, e)
    f = d.reshape(n_p, kch, 2, 4, 4, nb * g, _COLS).transpose(
        5, 1, 0, 6, 3, 2, 4).reshape(nb, g, kch, n_p * _FRAG)
    stages = [f[:, :, lo:lo + grid.sc].reshape(nb, -1)
              for lo in range(0, kch, grid.sc)]
    return np.ascontiguousarray(np.concatenate(stages, axis=1)).reshape(-1)


@dataclasses.dataclass(frozen=True)
class PackedPlanes:
    """One matrix's kept planes packed on a CUDA device, with what a call
    needs: the grid, the stage buffers and shared memory per x type
    (``launch[x_int8] = (n_buf, smem)``, ``None`` where a tile does not
    fit) and the kernel's entry point."""

    grid: PlaneGrid
    blob: torch.Tensor
    launch: dict
    fn: object = dataclasses.field(repr=False, compare=False)


def pack_planes(digits, plane_mask: tuple | None, device) -> PackedPlanes:
    """Pack (W, R, C) ``digits`` for the kernel on a CUDA ``device``: the
    kept planes only (one all-zero plane if none is kept)."""
    digits = np.asarray(digits.cpu() if torch.is_tensor(digits) else digits)
    if digits.ndim != 3 or digits.dtype != np.int8:
        raise ValueError("digits must be (W, R, C) int8")
    width, rows, cols = digits.shape
    if width > _MAX_PLANES:
        raise ValueError(f"{width} digit planes > {_MAX_PLANES}")
    planes = tuple(w for w, k in enumerate(_kept(plane_mask, width)) if k)
    if not planes:                      # nothing kept: one zero plane
        digits, planes = np.zeros((1, rows, cols), np.int8), (0,)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"pack_planes packs for a CUDA device, not {device}")
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = plane_grid(rows, cols, planes, n_sms)
    launch = {}
    for x_int8 in (True, False):
        try:
            n_buf = grid.buffers(x_int8)
            launch[x_int8] = (n_buf, grid.smem(n_buf, x_int8))
        except ValueError:
            launch[x_int8] = None
    return PackedPlanes(
        grid=grid, blob=torch.as_tensor(pack_blob(digits, grid),
                                        device=device),
        launch=launch, fn=LIBRARY.load().bitplane_gemv)


def _launch_packed(x: torch.Tensor, pk: PackedPlanes) -> torch.Tensor:
    _check_x(x)
    _launch.same_device(pk.blob.device, x)
    grid = pk.grid
    if x.dim() != 2 or x.shape[1] != grid.rows:
        raise ValueError(f"x must be (B, {grid.rows}), got {tuple(x.shape)}")
    if not _launch.unit_stride(x, 1):
        raise ValueError("bitplane_gemv needs x with unit stride over R")
    x_int8 = x.dtype == torch.int8
    if pk.launch[x_int8] is None:
        grid.buffers(x_int8)          # raises with the reason
    n_buf, smem = pk.launch[x_int8]
    b = x.shape[0]
    y = torch.empty((b, grid.cols), dtype=torch.int32, device=x.device)
    if b == 0:
        return y
    row_bytes = x.element_size()
    x_vec = (x.data_ptr() % 16 == 0 and (x.stride(0) * row_bytes) % 16 == 0
             and (grid.rows * row_bytes) % 16 == 0)
    rc = pk.fn(
        int(x_int8), x.data_ptr(), x.stride(0), b, grid.rows,
        pk.blob.data_ptr(), grid.cols, grid.groups, len(grid.planes),
        grid.shifts, grid.kch, grid.sc, grid.n_stages, n_buf,
        grid.share_bytes, grid.stage_bytes, grid.x_stride(x_int8),
        int(x_vec), y.data_ptr(), y.stride(0), grid.n_blocks, smem,
        _launch.stream(x.device))
    check(rc, "bitplane_gemv")
    bitplane_gemv.launches += 1
    obs.inc("kernel_launches_total", kernel="bitplane_gemv")
    return y


def bitplane_gemv(x: torch.Tensor, planes, *,
                  plane_mask: tuple | None = None) -> torch.Tensor:
    """B3: ``y[b, c] = sum_r x[b, r] * V[r, c]`` through digit planes.

    Args:
        x: (B, R) int8 or int32 activations (unit stride over R).
        planes: the (W, Rd, C) int8 digit planes in {-1, 0, 1}, ``Rd >=
            R`` (rows past R are ignored), V = sum 2^w planes[w]; or, for
            a CUDA x, the :class:`PackedPlanes` of :func:`pack_planes`
            (what :class:`~repro_torch.kernels.bitplane_gemv.ops.
            BitplaneGemv` passes: a CUDA x with raw planes packs them for
            this one call).
        plane_mask: per-plane keep flags (None keeps every plane).

    Returns:
        (B, C) int32: the product modulo 2^32, as int32 arithmetic gives
        it (exact for int8 x while 128 * 255 * R < 2^31).
    """
    if isinstance(planes, PackedPlanes):
        return _launch_packed(x, planes)
    _check_operands(x, planes)
    if not _launch.on_cuda(x, planes):
        return bitplane_gemv_plain(x, planes, plane_mask)
    return _launch_packed(x, pack_planes(planes[:, : x.shape[1]],
                                         plane_mask, x.device))


bitplane_gemv.launches = 0
