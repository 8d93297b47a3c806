"""Fixed sparse matrices compiled once, offline — the paper's core.

The FPGA flow takes a fixed matrix and runs it through synthesis/place&route
once, paying the specialization cost offline.  The analogue here is
:class:`FixedMatrix`: an offline compile step that

  1. quantizes the (frozen) matrix to signed ``weight_bits`` integers,
  2. decomposes it into PN or CSD digit planes (``core.bitplanes``),
  3. extracts a static block-sparse (BCSR) structure whose zero blocks are
     culled — at compile time, like the paper culls adders at synthesis,
  4. attaches the FPGA cost model so every instance reports the same
     area/latency/power numbers the paper's design flow would.

The compile artefacts (``q``, the digit planes, the block list) are numpy
arrays: they are built once on the host and lowered into device tables by
:mod:`repro_torch.plan`.  The math methods here are the plain PyTorch
reference paths; they run on whatever device their input tensor lives on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

from repro_torch.core import bitplanes as bp
from repro_torch.core import costmodel

__all__ = ["BlockSparse", "FixedMatrix", "random_sparse_matrix"]


def random_sparse_matrix(
    rows: int,
    cols: int,
    element_sparsity: float,
    rng: np.random.Generator,
    weight_bits: int | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Random fixed matrix with the paper's initialization scheme.

    Integer mode ("weights are sampled from a uniform distribution of all
    possible values for the given bit-width", Sec. IV) when ``weight_bits``
    is given; float uniform(-1, 1) otherwise.  Elements are then zeroed
    until the requested element sparsity is met.
    """
    if weight_bits is not None:
        lo, hi = -(1 << (weight_bits - 1)), (1 << (weight_bits - 1))
        m = rng.integers(lo, hi, size=(rows, cols)).astype(np.float64)
    else:
        m = rng.uniform(-1.0, 1.0, size=(rows, cols))
    mask = rng.random((rows, cols)) >= element_sparsity
    return (m * mask).astype(dtype)


@dataclasses.dataclass
class BlockSparse:
    """Static BCSR: block mask decided offline, data gathered per-nnz-block.

    The block mask is a host-side constant: kernels and reference paths
    iterate only the nonzero blocks, so zero blocks cost nothing at runtime —
    the analogue of the paper's constant propagation.
    """

    shape: tuple[int, int]
    block: int
    block_rows: np.ndarray        # (n_nnz,) int32 — block row index
    block_cols: np.ndarray        # (n_nnz,) int32 — block col index
    data: np.ndarray              # (n_nnz, block, block)
    mask: np.ndarray              # (nbr, nbc) bool

    @classmethod
    def from_dense(cls, dense: np.ndarray, block: int = 128) -> "BlockSparse":
        r, c = dense.shape
        nbr, nbc = math.ceil(r / block), math.ceil(c / block)
        padded = np.zeros((nbr * block, nbc * block), dtype=dense.dtype)
        padded[:r, :c] = dense
        tiles = padded.reshape(nbr, block, nbc, block).transpose(0, 2, 1, 3)
        mask = np.abs(tiles).sum(axis=(2, 3)) != 0
        br, bc = np.nonzero(mask)
        return cls(shape=(r, c), block=block, block_rows=br.astype(np.int32),
                   block_cols=bc.astype(np.int32),
                   data=np.ascontiguousarray(tiles[br, bc]), mask=mask)

    @property
    def n_blocks_total(self) -> int:
        return int(self.mask.size)

    @property
    def n_blocks_nnz(self) -> int:
        return int(self.mask.sum())

    @property
    def density(self) -> float:
        return self.n_blocks_nnz / max(self.n_blocks_total, 1)

    def to_dense(self) -> np.ndarray:
        nbr, nbc = self.mask.shape
        bk = self.block
        out = np.zeros((nbr * bk, nbc * bk), dtype=self.data.dtype)
        for i, (br, bc) in enumerate(zip(self.block_rows, self.block_cols)):
            out[br * bk:(br + 1) * bk, bc * bk:(bc + 1) * bk] = self.data[i]
        return out[: self.shape[0], : self.shape[1]]

    def matmul_ref(self, x: torch.Tensor,
                   tiles: torch.Tensor | None = None) -> torch.Tensor:
        """Blocked ``x @ M`` over nonzero blocks only.

        x: (..., rows) -> (..., cols).  The Python loop is over the static
        nonzero-block list — zero blocks are culled exactly like the
        paper's degenerate adders.  ``tiles`` is :attr:`data` already on
        ``x``'s device in its dtype (a caller that multiplies every step
        places it once); by default it is copied there on each call.
        """
        r, c = self.shape
        nbr, nbc = self.mask.shape
        bk = self.block
        xpad = x.new_zeros(x.shape[:-1] + (nbr * bk,))
        xpad[..., :r] = x
        data = (torch.as_tensor(self.data, device=x.device).to(x.dtype)
                if tiles is None else tiles)
        out = [None] * nbc
        for i in range(len(self.block_rows)):
            br, bc = int(self.block_rows[i]), int(self.block_cols[i])
            contrib = xpad[..., br * bk:(br + 1) * bk] @ data[i]
            out[bc] = contrib if out[bc] is None else out[bc] + contrib
        zeros = x.new_zeros(x.shape[:-1] + (bk,))
        cols = [o if o is not None else zeros for o in out]
        return torch.cat(cols, dim=-1)[..., :c]


def int_matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer ``a @ b`` -> int32 on any device.

    CUDA has no integer matmul in PyTorch, so the product runs in float64,
    which represents every partial sum of int8-range operands exactly
    (well below 2**53); the result converts back without rounding.
    """
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


@dataclasses.dataclass
class FixedMatrix:
    """A frozen matrix compiled for fast fixed-structure multiplication.

    ``y = x @ dense`` is reproduced three ways, all sharing one offline
    compile: exact integer digit-plane math (mirrors the FPGA bit-serial
    semantics), dequantized block-sparse float math, and — via
    :mod:`repro_torch.kernels` — CUDA kernels over the same static
    structure.
    """

    shape: tuple[int, int]
    weight_bits: int
    mode: Literal["pn", "csd"]
    scale: float                      # dequant scale: dense ~ q * scale
    planes: bp.DigitPlanes
    blocks: BlockSparse
    q: np.ndarray                     # (rows, cols) int8 quantized weights
    element_sparsity: float

    # -- compile ------------------------------------------------------------
    @classmethod
    def compile(
        cls,
        dense: np.ndarray,
        weight_bits: int = 8,
        mode: Literal["pn", "csd"] = "csd",
        block: int = 128,
        rng: np.random.Generator | None = None,
    ) -> "FixedMatrix":
        dense = np.asarray(dense, dtype=np.float64)
        qmax = (1 << (weight_bits - 1)) - 1
        amax = np.abs(dense).max()
        scale = (amax / qmax) if amax > 0 else 1.0
        q = np.clip(np.round(dense / scale), -qmax - 1, qmax).astype(np.int64)
        planes = bp.decompose(q, weight_bits, mode=mode, rng=rng)
        return cls.from_parts(q, float(scale), planes, block)

    @classmethod
    def from_parts(cls, q: np.ndarray, scale: float, planes: bp.DigitPlanes,
                   block: int) -> "FixedMatrix":
        """Assemble a compiled matrix from its quantized weights and digit
        planes (no decomposition is run, so the planes are taken as given
        — how weights compiled elsewhere are carried over bit for bit)."""
        q = np.asarray(q).astype(np.int64)
        # dequantize in float64, then round once to float32 tiles
        dequant = (q.astype(np.float32) * np.float64(scale)).astype(np.float32)
        blocks = BlockSparse.from_dense(dequant, block)
        sparsity = 1.0 - (np.count_nonzero(q) / q.size)
        return cls(shape=q.shape, weight_bits=planes.source_bits,
                   mode=planes.mode, scale=float(scale), planes=planes,
                   blocks=blocks, q=q.astype(np.int8),
                   element_sparsity=float(sparsity))

    # -- downstream lowering --------------------------------------------------
    def plan(self):
        """The shared :class:`repro_torch.plan.ExecutionPlan` lowering of
        this matrix (cached per instance; import deferred to avoid a
        cycle)."""
        from repro_torch.plan import plan_for
        return plan_for(self)

    # -- cost reporting -------------------------------------------------------
    @property
    def ones(self) -> int:
        return self.planes.ones

    def fpga_cost(self, input_bits: int = 8) -> costmodel.FPGADesignPoint:
        return costmodel.design_point(
            rows=self.shape[0], cols=self.shape[1],
            element_sparsity=self.element_sparsity,
            weight_bits=self.weight_bits, input_bits=input_bits,
            mode=self.mode, ones=self.ones)

    # -- math ----------------------------------------------------------------
    def device_planes(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The pos/neg digit planes on ``device`` as float64, the operand
        type :func:`int_matmul_exact` multiplies in."""
        return tuple(torch.as_tensor(p, device=device).to(torch.float64)
                     for p in (self.planes.pos, self.planes.neg))

    def matvec_int_exact(self, a: torch.Tensor,
                         planes: tuple | None = None) -> torch.Tensor:
        """Exact ``a @ q`` through shifted digit-plane products (int32).

        Mirrors the FPGA dataflow: one single-bit dot product per plane,
        shift-combined, PN subtracted.  ``a``: (..., rows) integer.
        ``planes`` is :meth:`device_planes` of ``a``'s device (a caller
        that multiplies every step places them once); by default they are
        copied there on each call.
        """
        a = a.to(torch.int32)
        pos, neg = self.device_planes(a.device) if planes is None else planes
        out = torch.zeros(a.shape[:-1] + (self.shape[1],), dtype=torch.int32,
                          device=a.device)
        for b in range(self.planes.width):
            pterm = int_matmul_exact(a, pos[b])
            nterm = int_matmul_exact(a, neg[b])
            out = out + ((pterm - nterm) << b)
        return out

    def matvec_int_dense_ref(self, a: torch.Tensor) -> torch.Tensor:
        return int_matmul_exact(a, torch.as_tensor(self.q, device=a.device))

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """Dequantized float path over the culled block structure."""
        return self.blocks.matmul_ref(x)

    def dense_f32(self, device=None) -> torch.Tensor:
        q = torch.as_tensor(self.q, device=device)
        return q.to(torch.float32) * self.scale
