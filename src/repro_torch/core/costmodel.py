"""FPGA cost / frequency / power / latency models — Sections IV and VI.

The paper's headline cost model is deliberately simple:

  * LUTs  ~= number of set digit bits ("ones") in the PN/CSD planes
            ("LUTs are essentially equivalent to the number of ones", Fig 10)
  * FFs   ~= 2 x LUTs ("there are two registers per LUT", Fig 10)
  * Fmax  : banded by SLR occupancy on the XCVU13P (Fig 11) —
            <=1 SLR: 597..445 MHz, <=2 SLR: 400..296 MHz, >2 SLR: 250..225 MHz
  * Power : static + dynamic ~ ones x f (Fig 12, ~150 W thermal limit)
  * Latency (Eq 5): BW_i + BW_w + log2(R) + 2 cycles.

Everything here is scalar math so the benchmark harness can sweep
thousands of design points instantly.  Calibrated constants are marked
``# calibrated:`` with the paper anchor that pins them.  (The rollout
schedule cost model that prices autotuner candidates arrives with the
autotuner port.)
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "XCVU13P",
    "FPGADesignPoint",
    "expected_ones",
    "luts_for_ones",
    "ffs_for_ones",
    "fmax_hz",
    "power_w",
    "latency_cycles",
    "design_point",
    "tpu_decode_bytes",
]

# --- Xilinx XCVU13P (paper Sec. VI) ---------------------------------------
@dataclasses.dataclass(frozen=True)
class _XCVU13P:
    total_luts: int = 1_700_000          # "capacity of 1.7M 6-input LUTs"
    total_ffs: int = 3_400_000           # "3.4M logic flip-flops"
    slr_luts: int = 425_000              # "maximum capacity of 425k LUTs" per SLR
    n_slr: int = 4                       # "four chiplets in the package"
    thermal_limit_w: float = 150.0       # "thermal power limit ... approximately 150W"


XCVU13P = _XCVU13P()

# Fmax bands measured in Fig 11 (place-and-route results).
_FMAX_BANDS = (
    # (lut_low, lut_high, f_at_low_hz, f_at_high_hz)
    (0,         425_000,   597e6, 445e6),   # "within one SLR ... 597MHz to 445MHz"
    (425_000,   850_000,   400e6, 296e6),   # "2 SLRs range from 296MHz to 400MHz"
    (850_000, 1_700_000,   250e6, 225e6),   # ">2 SLRs ... between 225MHz and 250MHz"
)

# calibrated: Vivado-style static floor + per-toggle energy such that a
# 1.5M-ones design at 225 MHz sits at the ~150 W thermal limit (Fig 12).
_STATIC_POWER_W = 3.0
_ENERGY_PER_ONE_TOGGLE_J = (XCVU13P.thermal_limit_w - _STATIC_POWER_W) / (1.5e6 * 225e6)


def expected_ones(
    rows: int,
    cols: int,
    element_sparsity: float,
    weight_bits: int = 8,
    mode: str = "pn",
) -> float:
    """Expected set digit bits for a random matrix (the paper's cost driver).

    Uniform nonzero magnitudes set half their magnitude bits on average; CSD
    recoding removes ~17% of them at 8-bit ("CSD ... reduces the hardware by
    17% for any level of element-sparsity", Fig 9).
    """
    nnz = rows * cols * (1.0 - element_sparsity)
    mag_bits = max(weight_bits - 1, 1)
    bits_per_nz = mag_bits / 2.0
    if mode == "csd":
        bits_per_nz *= 0.83  # paper Fig 9: -17% at any element sparsity
    return nnz * bits_per_nz


def luts_for_ones(ones: float) -> float:
    """Fig 10: 'LUTs are essentially equivalent to the number of ones'."""
    return float(ones)


def ffs_for_ones(ones: float) -> float:
    """Fig 10: 'there are two registers per LUT'."""
    return 2.0 * ones


def fmax_hz(luts: float) -> float:
    """Piecewise-linear Fmax within the paper's SLR occupancy bands (Fig 11)."""
    if luts > XCVU13P.total_luts:
        raise ValueError(
            f"design needs {luts:.0f} LUTs > device capacity "
            f"{XCVU13P.total_luts} (paper: 'bound by the number of 6-input LUTs')")
    for lo, hi, f_lo, f_hi in _FMAX_BANDS:
        if luts <= hi:
            frac = (luts - lo) / (hi - lo)
            return f_lo + frac * (f_hi - f_lo)
    raise AssertionError("unreachable")


def power_w(ones: float, f_hz: float) -> float:
    """Fig 12: static + activity-proportional dynamic power."""
    return _STATIC_POWER_W + _ENERGY_PER_ONE_TOGGLE_J * ones * f_hz


def latency_cycles(input_bits: int, weight_bits: int, rows: int) -> int:
    """Paper Eq. 5."""
    return input_bits + weight_bits + int(math.ceil(math.log2(rows))) + 2


@dataclasses.dataclass(frozen=True)
class FPGADesignPoint:
    """One compiled fixed-matrix design on the XCVU13P."""

    rows: int
    cols: int
    element_sparsity: float
    weight_bits: int
    input_bits: int
    mode: str
    ones: float
    luts: float
    ffs: float
    fmax_hz: float
    power_w: float
    cycles: int

    @property
    def latency_s(self) -> float:
        return self.cycles / self.fmax_hz

    @property
    def latency_ns(self) -> float:
        return self.latency_s * 1e9

    @property
    def slrs(self) -> int:
        return int(math.ceil(self.luts / XCVU13P.slr_luts)) or 1

    def batch_latency_s(self, batch: int) -> float:
        """Streaming batches through the spatial array is fully pipelined at
        one vector per ``input_bits`` cycles after the first result (the
        input shift registers are the only per-vector resource)."""
        extra = (batch - 1) * self.input_bits
        return (self.cycles + extra) / self.fmax_hz

    @property
    def fits(self) -> bool:
        return self.luts <= XCVU13P.total_luts


def design_point(
    rows: int,
    cols: int,
    element_sparsity: float,
    weight_bits: int = 8,
    input_bits: int = 8,
    mode: str = "pn",
    ones: float | None = None,
) -> FPGADesignPoint:
    """Build a design point; ``ones`` may come from a real decomposed matrix
    (exact) or default to the :func:`expected_ones` analytic estimate."""
    if ones is None:
        ones = expected_ones(rows, cols, element_sparsity, weight_bits, mode)
    luts = luts_for_ones(ones)
    f = fmax_hz(luts)
    return FPGADesignPoint(
        rows=rows, cols=cols, element_sparsity=element_sparsity,
        weight_bits=weight_bits, input_bits=input_bits, mode=mode,
        ones=ones, luts=luts, ffs=ffs_for_ones(ones), fmax_hz=f,
        power_w=power_w(ones, f),
        cycles=latency_cycles(input_bits, weight_bits, rows),
    )


# --- what the technique buys on a memory-bound gemv -------------------------
def tpu_decode_bytes(
    rows: int,
    cols: int,
    element_sparsity: float,
    weight_bits: int = 8,
    mode: str = "csd",
    block: int = 128,
) -> dict[str, float]:
    """Bytes one gemv must move under different weight encodings.

    Decode (batch-1 gemv) is memory-roofline-bound: latency ~ bytes / HBM_bw
    on any accelerator (the name is the JAX package's, which sized a TPU).
    The paper's fixed-matrix specialization maps to (a) int8 storage and
    (b) culling all-zero ``block x block`` tiles, with per-tile digit-plane
    counts from CSD.  Returns bytes per encoding for napkin comparison.
    """
    dense_bf16 = rows * cols * 2.0
    dense_int8 = rows * cols * 1.0
    # Probability a block has at least one nonzero element:
    p_nz_block = 1.0 - element_sparsity ** (block * block)
    n_blocks = math.ceil(rows / block) * math.ceil(cols / block)
    blocks_kept = n_blocks * p_nz_block
    bcsr_int8 = blocks_kept * block * block * 1.0 + n_blocks / 8.0
    # Digit-plane encoding: one bit per plane entry, planes kept per block.
    mag_bits = max(weight_bits - 1, 1)
    planes = mag_bits + (1 if mode == "csd" else 0)
    plane_density = (1.0 - element_sparsity) * (
        0.5 * (0.83 if mode == "csd" else 1.0))
    # Bitmap planes: block*block/8 bytes per kept (plane, block); a plane-block
    # is kept if any bit in it is set.
    p_keep = 1.0 - (1.0 - plane_density) ** (block * block)
    plane_bytes = n_blocks * planes * p_keep * (block * block / 8.0)
    return {
        "dense_bf16": dense_bf16,
        "dense_int8": dense_int8,
        "bcsr_int8": bcsr_int8,
        "digit_planes": plane_bytes,
    }
