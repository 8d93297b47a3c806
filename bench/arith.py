"""The benchmark's yardstick arithmetic: percentiles, the work and bytes of
a rollout launch, the H100's published peaks, roofline and MFU shares.

Counted from shapes and from the matrix the seed made, never read from
the program.
"""

from __future__ import annotations

import math

__all__ = ["PEAKS", "PEAK_SOURCE", "launch_bytes", "launch_ops",
           "least_seconds", "mfu_pct", "percentile", "roofline_pct",
           "step_ops"]

# One NVIDIA H100 SXM at its full 700 W, dense rates without sparsity
# (NVIDIA's data sheet): operations per second by the arithmetic a
# configuration states, and HBM bytes per second.
PEAKS = {"int8": 1979e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
PEAK_SOURCE = "NVIDIA H100 SXM data sheet, dense, 700 W"


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, interpolated
    linearly between the two nearest ranks (numpy's default method)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def arith(mode: str) -> str:
    """The arithmetic a configuration's ``mode`` serves in."""
    return "int8" if mode.startswith("int8") else "fp32"


def step_ops(nnz: int, dim: int, in_dim: int, out_dim: int) -> int:
    """Operations of one answered step of one sequence: the recurrent
    product over the matrix's nonzeros, the input projection and the
    readout, two per multiply-add."""
    return 2 * nnz + 2 * dim * in_dim + 2 * dim * out_dim


def launch_ops(nnz: int, dim: int, in_dim: int, out_dim: int, steps: int,
               batch: int) -> int:
    """Operations of one rollout launch of ``steps`` steps over ``batch``
    rows (every row the launch computes, padding rows included)."""
    return steps * batch * step_ops(nnz, dim, in_dim, out_dim)


def launch_bytes(kept_blocks: int, block: int, width: int, dim: int,
                 in_dim: int, out_dim: int, steps: int, batch: int) -> int:
    """Bytes a rollout launch must move at the least: the matrix's kept
    blocks at their stored ``width`` once, W_in and W_out, the inputs and
    the start states read once, the predictions and final states written
    once (all float32 but the matrix)."""
    matrix = kept_blocks * block * block * width
    weights = 4 * dim * (in_dim + out_dim)
    reads = 4 * (steps * batch * in_dim + batch * dim)
    writes = 4 * (steps * batch * out_dim + batch * dim)
    return matrix + weights + reads + writes


def least_seconds(ops: float, nbytes: float, arithmetic: str
                  ) -> tuple[float, str]:
    """The least time the chip needs for ``ops`` and ``nbytes``, and which
    of the two bounds sets it (``"compute"`` or ``"memory"``)."""
    t_ops = ops / PEAKS[arithmetic]
    t_mem = nbytes / HBM_BYTES_PER_S
    return (t_ops, "compute") if t_ops >= t_mem else (t_mem, "memory")


def roofline_pct(least: float, device_seconds: float) -> float:
    """Share of the roofline: the least time over the device time, in %."""
    if device_seconds <= 0:
        raise ValueError("no device time")
    return 100.0 * least / device_seconds


def mfu_pct(ops: float, seconds: float, arithmetic: str) -> float:
    """Model operations per second as a share of the peak, in %."""
    if seconds <= 0:
        raise ValueError("no time")
    return 100.0 * ops / seconds / PEAKS[arithmetic]
