"""Register-level functional emulation of the paper's bit-serial multiplier.

This module is the *fidelity oracle* for the reproduction: it simulates the
spatial design of Section III clock-by-clock —

  leaf ANDs -> per-plane bit-serial adder trees (one register per level)
  -> MSb-first combining chain (DFF for the MSb, then one bit-serial adder
     per remaining plane; chain position supplies the power-of-two weighting)
  -> final bit-serial subtractor for the PN split (carry seeded to 1).

All state elements (adder carries and output registers) are explicit, so the
emulator demonstrates that the architecture computes the exact integer gemv
and lets tests cross-check the latency bookkeeping of Eq. 5:

    Latency = BW_i + BW_w + log2(R) + 2           (paper Eq. 5)

The emulator is vectorized over matrix columns and digit planes with NumPy;
only the clock loop is Python.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.bitplanes import DigitPlanes, decompose

__all__ = ["SpatialResult", "pipeline_delay", "simulate_gemv", "eq5_latency"]


def eq5_latency(input_bits: int, weight_bits: int, rows: int) -> int:
    """Paper Eq. 5: BW_i + BW_w + log2(R) + 2 cycles."""
    return input_bits + weight_bits + int(math.ceil(math.log2(rows))) + 2


def pipeline_delay(tree_depth: int, plane_width: int) -> int:
    """Registers between the first input bit and the first output bit.

    One register per tree level, one per combining-chain stage (the MSb DFF
    plus W-1 adders = W stages), one for the PN subtractor.
    """
    return tree_depth + plane_width + 1


@dataclasses.dataclass(frozen=True)
class SpatialResult:
    output: np.ndarray        # (C,) int64 — the exact gemv result a^T V
    cycles_simulated: int     # clock cycles run to stream the full result out
    delay: int                # pipeline registers before the first output bit
    eq5: int                  # the paper's latency model for this instance
    ones: int                 # set bits across digit planes (hardware cost)


class _BitSerialAdder:
    """A rank of bit-serial adders, vectorized over an arbitrary shape."""

    def __init__(self, shape: tuple[int, ...], subtract: bool = False):
        self.subtract = subtract
        # "a bit-serial subtractor ... initializing the carry bit to 1, and
        #  adding a NOT gate between b's register and the full adder"
        self.carry = (np.ones if subtract else np.zeros)(shape, dtype=np.uint8)
        self.out = np.zeros(shape, dtype=np.uint8)

    def clock(self, a: np.ndarray, b: np.ndarray) -> None:
        if self.subtract:
            b = 1 - b
        s = a ^ b ^ self.carry
        self.carry = (a & b) | (a & self.carry) | (b & self.carry)
        self.out = s.astype(np.uint8)


def _input_bit(a: np.ndarray, t: int, input_bits: int) -> np.ndarray:
    """Two's-complement bit t of each input, sign-extended past BW_i.

    "To ensure signed inputs produce the correct sign bit, we sign extend the
    input a from the shift register until the computation has finished."
    """
    tt = min(t, input_bits - 1)
    return ((a.astype(np.int64) >> tt) & 1).astype(np.uint8)


class _PlaneStack:
    """Adder trees + MSb-first combining chain for one sign (P or N) stack."""

    def __init__(self, planes: np.ndarray):
        # planes: (W, R, C) uint8
        w, r, c = planes.shape
        self.width, self.rows, self.cols = w, r, c
        self.depth = max(1, int(math.ceil(math.log2(max(r, 2)))))
        self.rows_pad = 1 << self.depth
        pad = self.rows_pad - r
        self.planes = planes
        if pad:
            self.planes = np.concatenate(
                [planes, np.zeros((w, pad, c), dtype=np.uint8)], axis=1)
        # Tree level l halves the node count; level 0 consumes the leaf ANDs.
        self.tree = [
            _BitSerialAdder((w, self.rows_pad >> (l + 1), c))
            for l in range(self.depth)
        ]
        # Combining chain: stage 0 is the MSb DFF ("fed into a bit-serial
        # adder along with 0, which becomes a D flip-flop"), stages 1..W-1
        # add successively less-significant planes.  Chain position provides
        # the 2**b weighting — no explicit delay lines are needed.
        self.chain = [_BitSerialAdder((c,)) for _ in range(w)]

    def clock(self, abit: np.ndarray) -> np.ndarray:
        """Advance one cycle; returns the chain's registered output stream."""
        # Leaf ANDs: "because we are multiplying single bits, we can realize
        # the multiplication with a simple AND gate".  With the weight bit
        # fixed this is the constant propagation the paper culls in hardware;
        # the emulator keeps the gate to model the un-minimized dataflow.
        leaves = abit[None, :, None] & self.planes  # (W, Rp, C)

        # Synchronous update: every register consumes last cycle's outputs.
        tree_prev = [lvl.out.copy() for lvl in self.tree]
        chain_prev = [st.out.copy() for st in self.chain]

        x = leaves
        for l, lvl in enumerate(self.tree):
            lvl.clock(x[:, 0::2, :], x[:, 1::2, :])
            x = tree_prev[l]

        roots = tree_prev[-1][:, 0, :]  # (W, C) previous-cycle tree roots

        self.chain[0].clock(roots[self.width - 1],
                            np.zeros_like(roots[self.width - 1]))
        for k in range(1, self.width):
            self.chain[k].clock(chain_prev[k - 1], roots[self.width - 1 - k])
        return self.chain[-1].out


def simulate_gemv(
    matrix: np.ndarray,
    a: np.ndarray,
    input_bits: int,
    weight_bits: int,
    mode: str = "pn",
    rng: np.random.Generator | None = None,
    planes: DigitPlanes | None = None,
) -> SpatialResult:
    """Clock-level simulation of ``o = a^T V`` on the spatial architecture.

    Args:
        matrix: (R, C) signed integer weight matrix (the fixed reservoir V).
        a: (R,) signed integer input vector, |a| < 2**(input_bits-1).
        input_bits: streamed input precision BW_i.
        weight_bits: source weight precision BW_w.
        mode: "pn" or "csd" digit decomposition.
        rng: coin-flip source for CSD.
        planes: optionally a precompiled :class:`DigitPlanes` (skips decompose).

    Returns:
        :class:`SpatialResult` with the exact integer output and cycle counts.
    """
    matrix = np.asarray(matrix)
    a = np.asarray(a)
    if planes is None:
        planes = decompose(matrix, weight_bits, mode=mode, rng=rng)
    r, c = planes.shape

    pstack = _PlaneStack(planes.pos)
    nstack = _PlaneStack(planes.neg)
    sub = _BitSerialAdder((c,), subtract=True)

    depth = pstack.depth
    width = pstack.width
    # Structural latency (registers input->output); reported for bookkeeping.
    delay = pipeline_delay(depth, width)
    # Stream-value reconstruction shift: every tree level multiplies the
    # output stream's value by 2; the combining-chain registers are absorbed
    # into the 2**j plane weighting and the subtractor is read same-cycle in
    # this model, so the net left-shift of the captured stream is `depth`.
    shift = depth
    # Full-precision result width; the output stream is sign-extended past it.
    result_width = input_bits + width + depth + 2
    total = delay + result_width

    # Zero-pad the input vector to the padded leaf count.
    a_pad = np.zeros(pstack.rows_pad, dtype=np.int64)
    a_pad[:r] = a.astype(np.int64)

    acc = [0] * c  # arbitrary-precision two's-complement accumulation
    for t in range(total):
        abit = _input_bit(a_pad, t, input_bits)
        p_out = pstack.clock(abit)
        n_out = nstack.clock(abit)
        sub.clock(p_out, n_out)
        bits = sub.out
        for j in range(c):
            acc[j] |= int(bits[j]) << t

    window = total
    vals = np.empty(c, dtype=np.int64)
    for j in range(c):
        v = acc[j] & ((1 << window) - 1)
        if v >> (window - 1):
            v -= 1 << window
        vals[j] = v >> shift

    return SpatialResult(
        output=vals,
        cycles_simulated=total,
        delay=delay,
        eq5=eq5_latency(input_bits, weight_bits, r),
        ones=planes.ones,
    )
