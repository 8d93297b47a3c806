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
``# calibrated:`` with the paper anchor that pins them.  The second half
is the rollout schedule cost model the plan autotuner
(:mod:`repro_torch.plan.autotune`) prices its candidates with.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "XCVU13P",
    "FPGADesignPoint",
    "ROLLOUT_FEATURES",
    "RolloutCostModel",
    "expected_ones",
    "luts_for_ones",
    "ffs_for_ones",
    "fmax_hz",
    "power_w",
    "latency_cycles",
    "design_point",
    "tpu_decode_bytes",
    "rollout_cost_features",
    "default_rollout_cost_model",
    "fit_rollout_cost",
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


# --- Rollout schedule cost model (plan autotuning) -------------------------
# The same "simple and extensible" philosophy as the FPGA model above,
# pointed at the rollout: a specialized RolloutProgram's runtime is a linear
# combination of the work terms its schedule implies.  The autotuner
# (repro_torch.plan.autotune) prices every candidate schedule with these
# coefficients, prunes, then measures the survivors — and
# ``fit_rollout_cost`` closes the loop by refitting the coefficients from
# the measured rows, so the prior below only has to get the *ordering*
# roughly right, never the absolute seconds.

ROLLOUT_FEATURES = (
    "matmul_macs",     # folded-tile MAC count across the whole rollout
    "shiftadd_ops",    # unrolled digit adds across the whole rollout
    "stream_bytes",    # weight bytes moved (once if resident, per step if
                       # pipelined — the regime axis of the search)
    "band_steps",      # band iterations (per-band overhead)
    "tile_steps",      # batch-tile iterations (per-tile overhead)
    "steps",           # recurrence steps (per-step dispatch overhead)
)


def rollout_cost_features(summary: dict, block: int, batch: int,
                          steps: int = 1) -> dict:
    """Work terms of one specialized schedule over a ``(batch, steps)``
    rollout, computed from
    :func:`~repro_torch.plan.specialize.specialize_summary` counts only —
    no tile data is ever materialized to price a candidate.
    """
    batch_tile_max = summary.get("batch_tile_max", 16)
    n_tiles = max(1, -(-batch // batch_tile_max))
    b_tile = -(-batch // n_tiles)
    b_pad = b_tile * n_tiles
    itemsize = 4 if summary["mode"] == "fp32" else 1
    tile_bytes = block * block * itemsize
    payload = summary["n_matmul_terms"] * tile_bytes
    if summary["regime"] == "resident":
        stream = payload                       # staged once
    else:
        stream = payload * steps               # re-streamed every step
    return {
        "matmul_macs": summary["n_matmul_terms"] * block * block
        * b_pad * steps,
        "shiftadd_ops": summary["shiftadd_digits"] * b_pad * steps,
        "stream_bytes": stream,
        "band_steps": summary["n_bands"] * steps,
        "tile_steps": summary["n_bands"] * n_tiles * steps,
        "steps": steps,
    }


@dataclasses.dataclass
class RolloutCostModel:
    """Per-backend linear model over :data:`ROLLOUT_FEATURES` + intercept.

    ``coeffs[backend]`` is an ndarray of ``len(ROLLOUT_FEATURES) + 1``
    seconds-per-unit weights (intercept last).  Coefficients come from
    :func:`default_rollout_cost_model` (platform prior) or
    :func:`fit_rollout_cost` (calibrated against measured rows).
    """

    coeffs: dict
    platform: str = "cpu"

    def predict(self, backend: str, features: dict) -> float:
        c = self.coeffs.get(backend)
        if c is None:
            raise KeyError(f"no coefficients for backend {backend!r} "
                           f"(have {sorted(self.coeffs)})")
        v = np.array([features[k] for k in ROLLOUT_FEATURES] + [1.0])
        return float(v @ np.asarray(c))

    def as_dict(self) -> dict:
        return {"platform": self.platform,
                "features": list(ROLLOUT_FEATURES) + ["intercept"],
                "coeffs": {bk: [float(x) for x in c]
                           for bk, c in self.coeffs.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "RolloutCostModel":
        return cls(coeffs={bk: np.asarray(c, np.float64)
                           for bk, c in d["coeffs"].items()},
                   platform=d.get("platform", "cpu"))


# Platform priors, keyed by torch device type; intercept last.
_PRIORS = {
    # The JAX package's CPU prior with its backends renamed (xla -> torch,
    # pallas -> cuda).  Off the card the cuda backend runs the kernels'
    # plain twins (the port's interpret mode), so its per-term
    # coefficients carry a penalty large enough that it never survives
    # pruning there.
    "cpu": {
        #        macs    shiftadd stream   band     tile     step  icept
        "torch": [2e-11, 2e-9, 2e-11, 2e-6, 1e-6, 2e-6, 1e-4],
        "cuda": [2e-9, 2e-7, 2e-9, 1e-3, 1e-3, 1e-2, 1e-2],
    },
    # H100 prior: fit_rollout_cost over the 50 measured trials (44 cuda,
    # 6 torch; host clock around a synchronised rollout, best of 3) of the
    # first tuning run of chip_smoke.py's autotune phase on an NVIDIA H100
    # 80GB HBM3 with a 700.00 W power limit, which PERF.md names as this
    # prior's source.  Matrices: LARGE_1024 int8, PAPER_BASELINE fp32 and
    # a banded dim-1024 int8 matrix with 22 of 64 blocks kept, each at
    # batch 8 x 8 steps and batch 16 x 32 steps.  That run timed crossovers
    # that build one launch under several names; a later run with one
    # trial per launch refit cuda coefficients no closer to its own trials
    # than this prior (median relative error 0.576 against 0.572), so this
    # prior stays.  Its torch refit came closer (16.8 against 23.7), but no
    # choice turns on it: the backend gap is 3-385x.  No torch trial had
    # shift-add digits, so the torch shiftadd weight is the fit's starting
    # guess.  Crossovers that build other launches (128 and 256 against
    # 64) measured within the host clock's spread, so a cold cache on the
    # card serves the default schedule (plan.autotune.resolve_schedule).
    "cuda": {
        # the per-step PyTorch loop: host-bound, paid per step (the fit
        # clipped macs to 0: the culled schedule has fewer MACs than the
        # dense one and takes longer)
        "torch": [0.0, 1e-07, 0.0, 0.001124, 0.001134, 0.001324, 0.004599],
        # one B2 launch per call: per-step and per-tile costs; the
        # matrix's size enters through stream_bytes (macs clipped to 0)
        "cuda": [0.0, 1.962e-12, 1.004e-10, 1.809e-06, 2.97e-06,
                 4.809e-06, 0.0],
    },
}


def default_rollout_cost_model(platform: str = "cpu") -> RolloutCostModel:
    """Platform prior for the rollout cost model: ``"cpu"`` or ``"cuda"``
    (a torch device type).

    What the autotuner's pruning needs of a prior is only that the
    *relative* cost of the backends and schedules is right;
    :func:`fit_rollout_cost` calibrates the seconds.
    """
    if platform not in _PRIORS:
        raise ValueError(f"no rollout cost prior for platform {platform!r} "
                         f"(have {sorted(_PRIORS)})")
    return RolloutCostModel(
        coeffs={bk: np.asarray(c, np.float64)
                for bk, c in _PRIORS[platform].items()},
        platform=platform)


def fit_rollout_cost(samples, platform: str = "cpu") -> RolloutCostModel:
    """Calibrate the cost model from measured rows.

    ``samples``: iterable of ``(backend, features_dict, measured_seconds)``
    — the autotuner's measured trials.  Per backend, a ridge regression
    regularized toward the platform prior (a tuning run yields few rows
    against 7 unknowns, so the prior anchors the underdetermined
    directions), with coefficients clipped nonnegative — a negative
    seconds-per-op weight is always noise.  Backends with no samples keep
    their prior.
    """
    base = default_rollout_cost_model(platform)
    coeffs = dict(base.coeffs)
    by_backend: dict = {}
    for backend, feats, seconds in samples:
        by_backend.setdefault(backend, []).append((feats, float(seconds)))
    n_coef = len(ROLLOUT_FEATURES) + 1
    for backend, rows in by_backend.items():
        a = np.array([[f[k] for k in ROLLOUT_FEATURES] + [1.0]
                      for f, _s in rows], np.float64)
        y = np.array([s for _f, s in rows], np.float64)
        scale = np.abs(a).max(axis=0)
        scale[scale == 0] = 1.0
        an = a / scale
        c0 = np.asarray(base.coeffs.get(backend,
                                        np.zeros(n_coef))) * scale
        lam = 1e-2
        lhs = an.T @ an + lam * np.eye(n_coef)
        rhs = an.T @ y + lam * c0
        c = np.linalg.solve(lhs, rhs) / scale
        coeffs[backend] = np.maximum(c, 0.0)
    return RolloutCostModel(coeffs=coeffs, platform=platform)


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
