"""Bit-plane / digit-plane decomposition of fixed integer matrices.

Section III of the paper maps a fixed matrix into per-bit-position hardware:
each bit position of the weights gets its own single-bit dot-product circuit
and the positions are combined through a chain of bit-serial adders (delay of
one cycle per position == multiply by two).  Signed weights are handled by
splitting the matrix into positive and negative unsigned parts (PN split) and
subtracting the two result streams.

The analogue implemented here: ``V = sum_b 2**b * (P_b - N_b)`` where
``P_b`` / ``N_b`` are {0,1} planes.  A gemv against V becomes a sum of shifted
plane-gemvs — exactly the computation the FPGA performs in time, executed in
space on the GPU.  The number of nonzero plane entries ("ones") is the paper's
cost metric and drives both the FPGA cost model and the rollout kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from repro_torch.core import csd as csd_mod

__all__ = [
    "pn_split",
    "to_bitplanes",
    "from_bitplanes",
    "DigitPlanes",
    "decompose",
]


def pn_split(matrix: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a signed integer matrix into unsigned ``(P, N)`` with V = P - N.

    "An easy way to implement signed weights is to separate the positive and
    negative terms of the b vector into two separate unsigned vectors, and
    simply subtract the two resultant streams." (paper, Sec. III-c)
    """
    m = np.asarray(matrix)
    return np.where(m > 0, m, 0).astype(np.int64), np.where(m < 0, -m, 0).astype(np.int64)


def to_bitplanes(matrix: np.ndarray, width: int) -> np.ndarray:
    """Unsigned integer matrix -> uint8 bit planes of shape ``(width, *shape)``.

    Plane ``b`` holds bit ``b`` (LSb = plane 0), so
    ``matrix == sum_b 2**b * planes[b]``.
    """
    m = np.asarray(matrix).astype(np.int64)
    if m.size and (m.min() < 0 or m.max() >= (1 << width)):
        raise ValueError("matrix must be unsigned and fit in `width` bits")
    shifts = np.arange(width, dtype=np.int64).reshape((width,) + (1,) * m.ndim)
    return ((m[None, ...] >> shifts) & 1).astype(np.uint8)


def from_bitplanes(planes: np.ndarray) -> np.ndarray:
    """Inverse of :func:`to_bitplanes` (planes may be signed digit planes)."""
    width = planes.shape[0]
    weights = (1 << np.arange(width, dtype=np.int64)).reshape(
        (width,) + (1,) * (planes.ndim - 1))
    return (planes.astype(np.int64) * weights).sum(axis=0)


@dataclasses.dataclass(frozen=True)
class DigitPlanes:
    """A fixed signed matrix compiled to unsigned P/N digit planes.

    Attributes:
        pos: uint8 planes ``(width, rows, cols)`` for the positive part.
        neg: uint8 planes ``(width, rows, cols)`` for the negative part.
        mode: "pn" (plain positive/negative split) or "csd".
        source_bits: bit width of the original signed weights.
    """

    pos: np.ndarray
    neg: np.ndarray
    mode: Literal["pn", "csd"]
    source_bits: int

    @property
    def width(self) -> int:
        return self.pos.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return self.pos.shape[1:]

    @property
    def ones(self) -> int:
        """Total set bits across both plane stacks — the paper's cost metric."""
        return int(self.pos.sum() + self.neg.sum())

    def to_dense(self) -> np.ndarray:
        return from_bitplanes(self.pos) - from_bitplanes(self.neg)

    def ones_per_plane(self) -> np.ndarray:
        """Set bits per (sign, plane); shape (2, width)."""
        axes = tuple(range(1, self.pos.ndim))
        return np.stack([self.pos.sum(axis=axes), self.neg.sum(axis=axes)])


def decompose(
    matrix: np.ndarray,
    weight_bits: int,
    mode: Literal["pn", "csd"] = "pn",
    rng: np.random.Generator | None = None,
) -> DigitPlanes:
    """Compile a signed integer matrix into digit planes.

    This is the software analogue of the paper's "design flow [that] takes the
    content of the matrices and compiles it to a physical design": the matrix
    is fixed, so all decomposition cost is paid once, offline.

    Args:
        matrix: signed integers in [-(2**(weight_bits-1)), 2**(weight_bits-1)).
        weight_bits: source precision (the paper uses 8-bit signed).
        mode: "pn" splits positive/negative magnitudes into plain bit planes;
            "csd" additionally recodes each magnitude into canonical signed
            digits (Sec. V) — CSD digits of either sign land in the matching
            P/N stack ("positive elements that result from CSD remain in the
            original matrix, and negative elements are transferred to the
            opposite weight matrix").
        rng: coin-flip source for CSD length-2 chains.
    """
    m = np.asarray(matrix).astype(np.int64)
    lo, hi = -(1 << (weight_bits - 1)), (1 << (weight_bits - 1))
    if m.size and (m.min() < lo or m.max() >= hi):
        raise ValueError(f"weights out of signed {weight_bits}-bit range")

    p_int, n_int = pn_split(m)
    mag_bits = weight_bits - 1 if weight_bits > 1 else 1
    # |v| can reach 2**(weight_bits-1) for the most negative value.
    if n_int.size and n_int.max() > (1 << mag_bits) - 1:
        mag_bits += 1

    if mode == "pn":
        pos = to_bitplanes(p_int, mag_bits)
        neg = to_bitplanes(n_int, mag_bits)
        return DigitPlanes(pos=pos, neg=neg, mode="pn", source_bits=weight_bits)

    if mode != "csd":
        raise ValueError(f"unknown mode {mode!r}")

    if rng is None:
        rng = np.random.default_rng(0)
    # CSD on both unsigned magnitude matrices; width grows by one digit.
    dig_p = csd_mod.csd_transform(p_int, mag_bits, rng)  # (*shape, mag_bits+1)
    dig_n = csd_mod.csd_transform(n_int, mag_bits, rng)
    # Digits are LSb-first on the last axis; move planes to axis 0.
    dig_p = np.moveaxis(dig_p, -1, 0)
    dig_n = np.moveaxis(dig_n, -1, 0)
    # P stack: +digits of P and -digits of N.  N stack: the converse.
    pos = ((dig_p > 0) | (dig_n < 0)).astype(np.uint8)
    neg = ((dig_p < 0) | (dig_n > 0)).astype(np.uint8)
    return DigitPlanes(pos=pos, neg=neg, mode="csd", source_bits=weight_bits)
