"""Fused reservoir state update (B5): the CUDA kernel and its plain twin.

One step of paper Eq. 1 for a batch of reservoir states over a dense
reservoir matrix:

    x' = (1 - leak) * x + leak * tanh(u @ W_in + x @ W)

The kernel (``csrc/reservoir_step.cu``) fuses both products with the
activation and the leak, so the pre-activation never goes through device
memory — the recurrent latency path the paper optimizes.  It reads each
thread block's rows x columns of W as one contiguous share, packed once
(:func:`pack_weights`); the blocks that split the rows of a column slice
form a cluster and add their partial sums in distributed shared memory.
A CUDA tensor goes through the kernel or raises; a CPU tensor takes
:func:`reservoir_step_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib

import torch

from repro_torch import obs
from repro_torch.kernels import _launch
from repro_torch.kernels._build import CudaLibrary, check

__all__ = ["LIBRARY", "PackedStep", "StepGrid", "pack_share_blob",
           "pack_weights", "reservoir_step", "reservoir_step_plain",
           "step_grid"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "reservoir_step.cu",
    {"reservoir_step": [
        _P, _I, _P, _I,       # x, ld_x, u, ld_u
        _P, _I, _P,           # w_in, in_dim, blob
        _I, _I, _I, _I, _I,   # batch, dim, cw, rows, parts
        _I, _I,               # per_shift, x_vec
        _F, _F,               # one_minus_leak, leak
        _P, _I, _I,           # out, ld_out, b_tile
        _I, _I,               # n_blocks, smem
        _P]},                 # stream
    headers=(_launch.COMMON_HEADER, _launch.HOPPER_HEADER))

# The kernel's geometry (csrc/reservoir_step.cu).
_THREADS = 256
_BAR_BYTES = 64               # the stages' and the inbox's mbarriers
_MAX_CLUSTER = 8              # the portable cluster size
_SLICE_COLS = (128, 64, 32, 16, 8)   # column-slice widths, widest first
_BATCH_TILES = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class StepGrid:
    """The launch geometry of one step at one batch tile.

    Block ``sl * parts + p`` owns columns ``sl * cw .. + cw`` and rows
    ``p * rows .. + rows`` of W (its share); the ``parts`` blocks of a
    column slice form a cluster and add their partial sums in rank order.
    A thread owns 4 columns x ``rb`` batch rows of the block's ``b_tile``
    and every ``lanes``-th row of the share.
    """

    dim: int
    b_tile: int
    cw: int
    parts: int

    @property
    def rows(self) -> int:
        """Rows of W per part, a multiple of 4 (zero past ``dim``)."""
        return -(-self.dim // (4 * self.parts)) * 4

    @property
    def slices(self) -> int:
        return -(-self.dim // self.cw)

    @property
    def n_blocks(self) -> int:
        return self.slices * self.parts

    @property
    def share_bytes(self) -> int:
        return self.rows * self.cw * 4

    @property
    def rb(self) -> int:
        """Batch rows of a thread's register tile: 8 at a 16-row batch
        tile (4 x 8 measured faster than 4 x 4 there), else up to 4."""
        return 8 if self.b_tile == 16 else min(4, self.b_tile)

    @property
    def lanes(self) -> tuple[int, int]:
        """(row lanes, of which share a warp): the in-warp lanes are summed
        by a shuffle butterfly, the groups of them in ascending order."""
        quads = self.cw // 4
        lanes = _THREADS // (quads * (self.b_tile // self.rb))
        return lanes, min(lanes, 32 // min(quads, 8))

    @property
    def per(self) -> int:
        """Outputs each part of a cluster finishes: a power of two, at
        least a quad."""
        return max(4, self.b_tile * self.cw // self.parts)

    @property
    def smem(self) -> int:
        """Dynamic shared memory of one block: the mbarriers, the share, its
        x rows, the partial sums of the warp groups (when there are more
        than one) and the inbox for the cluster's sums of this block's
        outputs."""
        lanes, in_warp = self.lanes
        groups = lanes // in_warp
        n = self.b_tile * self.cw
        red = groups * n if groups > 1 else 0
        return (_BAR_BYTES + self.share_bytes + self.rows * self.b_tile * 4
                + (red + self.parts * self.per) * 4)


# (cluster parts, columns per block) by batch tile: the fastest grid of
# the sweep at LARGE_1024 on the H100 (tools/probe_fixed_kernels.py)
_PREFERRED = {16: (8, 128), 8: (4, 64), 4: (2, 16), 2: (2, 16), 1: (2, 16)}


def step_grid(dim: int, b_tile: int, n_sms: int) -> StepGrid:
    """The grid for a (dim, dim) W at ``b_tile`` batch rows per block on
    ``n_sms`` SMs.

    Start from the batch tile's measured grid (``_PREFERRED``).  At
    LARGE_1024 on an NVIDIA H100 80GB HBM3 at 700 W
    (``tools/probe_fixed_kernels.py``) the row split pays for itself as
    the batch grows: at batch 16, 8 parts of 128 columns (64 blocks) and
    of 64 columns (128 blocks) tie at 5.1-5.2 us, where without a cluster
    each block stages all of x and takes 7.8-8.6 us; at batch 1 the
    fastest grids lie within 5 % of each other (2.5-2.6 us), and 2 parts
    of 16 columns came within 3 % of the fastest in every sweep.  Take no
    more parts than 128-row pieces of W; narrow the slices while fewer
    than a quarter of the SMs would have a block and while the share does
    not fit one block's shared memory; if it never fits, split the rows
    further.  Raises a ValueError naming the shape when even 8 parts of 8
    columns do not fit."""
    if b_tile not in _PREFERRED:
        raise ValueError(f"batch tile must be one of {_BATCH_TILES}, got "
                         f"{b_tile}")
    parts, cw = _PREFERRED[b_tile]
    parts = min(parts, 1 << (-(-dim // 128) - 1).bit_length())
    while True:
        fits = [g for g in (StepGrid(dim, b_tile, w, parts)
                            for w in _SLICE_COLS if w <= cw)
                if g.smem <= _launch.MAX_SMEM]
        if fits:
            return next((g for g in fits if g.n_blocks >= n_sms // 4),
                        fits[-1])
        if parts == _MAX_CLUSTER:
            break
        parts *= 2
    narrow = StepGrid(dim, b_tile, _SLICE_COLS[-1], parts)
    raise ValueError(
        f"reservoir_step: a ({dim}, {dim}) W at {b_tile} batch rows per "
        f"block needs {narrow.smem} B of shared memory per block even in "
        f"{parts} parts of {narrow.cw} columns > {_launch.MAX_SMEM}")


def pack_share_blob(w: torch.Tensor, grid: StepGrid) -> torch.Tensor:
    """Every block's share, contiguous and on ``w``'s device: a
    ``(n_blocks, rows, cw)`` float32 tensor, block ``sl * parts + p``
    holding rows ``p * rows ..`` and columns ``sl * cw ..`` of W, zero
    past the matrix."""
    g = grid
    wp = w.new_zeros((g.parts * g.rows, g.slices * g.cw), dtype=torch.float32)
    wp[:g.dim, :g.dim] = w
    # contiguous: with one part the permuted view would reshape without a
    # copy, leaving W's own row-major bytes under the blob's pointer
    return wp.view(g.parts, g.rows, g.slices, g.cw).permute(
        2, 0, 1, 3).contiguous().view(g.n_blocks, g.rows, g.cw)


@dataclasses.dataclass(frozen=True)
class PackedStep:
    """A (dim, dim) W packed on a CUDA device: the grid of each batch tile
    that fits, the shares of each distinct (cw, parts) and the kernel's
    entry point."""

    dim: int
    n_sms: int
    grids: dict
    blobs: dict
    fn: object = dataclasses.field(repr=False, compare=False)
    _args: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    def grid(self, b_tile: int) -> StepGrid:
        """The grid of a batch tile; raises (naming the shape) for one that
        does not fit."""
        g = self.grids.get(b_tile)
        return g if g is not None else step_grid(self.dim, b_tile, self.n_sms)

    def launch_args(self, b_tile: int) -> tuple:
        """(shares, cw, rows, parts, log2 per, n_blocks, smem) of a batch
        tile, worked out once (a call's host cost is most of a step)."""
        args = self._args.get(b_tile)
        if args is None:
            g = self.grid(b_tile)
            args = self._args[b_tile] = (
                self.blobs[g.cw, g.parts], g.cw, g.rows, g.parts,
                g.per.bit_length() - 1, g.n_blocks, g.smem)
        return args


def pack_weights(w, device, b_tiles=_BATCH_TILES) -> PackedStep:
    """Pack a (dim, dim) float32 W for the kernel on a CUDA ``device``:
    the shares of the grid of every batch tile in ``b_tiles`` that fits;
    raises (naming the shape) when none does."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"pack_weights packs for a CUDA device, not {device}")
    w = torch.as_tensor(w, dtype=torch.float32, device=device)
    dim = _check_w(w)
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    grids, error = {}, None
    for bt in b_tiles:
        try:
            grids[bt] = step_grid(dim, bt, n_sms)
        except ValueError as e:
            error = e
    if not grids:
        raise error
    blobs = {}
    for g in grids.values():
        if (g.cw, g.parts) not in blobs:
            blobs[g.cw, g.parts] = pack_share_blob(w, g)
    return PackedStep(dim=dim, n_sms=n_sms, grids=grids, blobs=blobs,
                      fn=LIBRARY.load().reservoir_step)


def _check_operands(x, dim, u, w_in, out):
    b = x.shape[0]
    if x.dim() != 2 or x.shape[1] != dim or u.dim() != 2 or u.shape[0] != b:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"({dim}, {dim}), u {tuple(u.shape)}")
    if w_in.shape != (u.shape[1], dim):
        raise ValueError(f"w_in must be ({u.shape[1]}, {dim}), got "
                         f"{tuple(w_in.shape)}")
    if out is not None and out.shape != (b, dim):
        raise ValueError(f"out must be ({b}, {dim}), got {tuple(out.shape)}")
    if out is not None and _launch.overlaps(out, x):
        raise ValueError("out must not overlap x")


def _check_w(w: torch.Tensor) -> int:
    if w.dim() != 2 or w.shape[0] != w.shape[1]:
        raise ValueError(f"w must be square, got {tuple(w.shape)}")
    return w.shape[0]


def reservoir_step_plain(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                         w_in: torch.Tensor, *, leak: float = 1.0,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of :func:`reservoir_step`."""
    _check_operands(x, _check_w(w), u, w_in, out)
    nxt = (1.0 - leak) * x + leak * torch.tanh(u @ w_in + x @ w)
    if out is None:
        return nxt
    return out.copy_(nxt)


def _launch_packed(x, pk: PackedStep, u, w_in, leak, out):
    b, dim = x.shape
    bt = _launch.batch_tile(b)
    blob, cw, rows, parts, per_shift, n_blocks, smem = pk.launch_args(bt)
    _launch.same_device(blob.device, x, u, w_in, out)
    _launch.check_f32(x, u, w_in, out)
    if out is None:
        out = torch.empty((b, dim), device=x.device)
    if not w_in.is_contiguous() or not all(
            _launch.unit_stride(t, 1) for t in (x, u, out)):
        raise ValueError("reservoir_step needs a contiguous w_in and x, u, "
                         "out with unit stride over their last dim")
    if b == 0:
        return out
    x_vec = x.data_ptr() % 16 == 0 and (b == 1 or x.stride(0) % 4 == 0)
    rc = pk.fn(
        x.data_ptr(), x.stride(0), u.data_ptr(), u.stride(0),
        w_in.data_ptr(), u.shape[1], blob.data_ptr(),
        b, dim, cw, rows, parts, per_shift, int(x_vec),
        1.0 - leak, leak, out.data_ptr(), out.stride(0), bt,
        n_blocks, smem, _launch.stream(x.device))
    check(rc, "reservoir_step")
    reservoir_step.launches += 1
    obs.inc("kernel_launches_total", kernel="reservoir_step")
    return out


def reservoir_step(x: torch.Tensor, w, u: torch.Tensor, w_in: torch.Tensor,
                   *, leak: float = 1.0,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """B5: one fused ESN step for a state batch.

    Args:
        x: (B, R) float32 current states (unit stride over R).
        w: (R, R) float32 reservoir matrix; or, for a CUDA x, the
            :class:`PackedStep` of :func:`pack_weights` (what
            :class:`~repro_torch.kernels.reservoir_step.ops.FusedReservoir`
            passes: a CUDA x with a raw W packs it for this one call).
        u: (B, I) float32 inputs (unit stride over I), I >= 1.
        w_in: (I, R) float32 input weights, contiguous.
        leak: Eq. 1's leak rate.
        out: optional (B, R) buffer (unit stride over R, not overlapping
            x) that receives the next states in place.

    Returns:
        (B, R) next states, float32 (``out`` when given).
    """
    if isinstance(w, PackedStep):
        _check_operands(x, w.dim, u, w_in, out)
        return _launch_packed(x, w, u, w_in, leak, out)
    _check_operands(x, _check_w(w), u, w_in, out)
    if not _launch.on_cuda(x, w, u, w_in, out):
        return reservoir_step_plain(x, w, u, w_in, leak=leak, out=out)
    _launch.check_f32(w)
    pk = pack_weights(w, x.device, b_tiles=(_launch.batch_tile(x.shape[0]),))
    return _launch_packed(x, pk, u, w_in, leak, out)


reservoir_step.launches = 0
