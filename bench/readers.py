"""Reductions shared by the metric files of ``bench/metrics``.

Each returns ``None`` where its run has nothing to read (an untraced run,
another entry, no launch), so the metric is left out of the line.
"""

from __future__ import annotations

from bench import arith
from bench.devtrace import busy_ns, op_totals

__all__ = ["ROLLOUT_KERNELS", "rollout_device_ns", "rollout_us_per_step",
           "device_idle_pct"]

# the rollout launch's kernels (kernels/reservoir_rollout/csrc/rollout.cu)
ROLLOUT_KERNELS = ("rollout_kernel", "readout_kernel")


def rollout_device_ns(run) -> int | None:
    """Device nanoseconds of the rollout kernels in the traced window."""
    if run.trace is None:
        return None
    ns = sum(t for name, t in op_totals(run.device_ops()).items()
             if any(k in name for k in ROLLOUT_KERNELS))
    return ns or None


def rollout_us_per_step(run) -> float | None:
    """Rollout device microseconds per step a launch rolled (a step of the
    launch's whole batch)."""
    ns = rollout_device_ns(run)
    steps = sum(t for t, _b in run.window.launches)
    if ns is None or not steps:
        return None
    return ns / 1e3 / steps


def rollout_least_s(run) -> tuple[float, str]:
    """The least seconds the window's launches need, and the bound that
    sets the larger share of it."""
    c = run.cfg
    width = 1 if run.arith == "int8" else 4
    total, by = 0.0, {}
    for t, b in run.window.launches:
        ops = arith.launch_ops(run.nnz, c["reservoir_dim"], c["input_dim"],
                               c["output_dim"], t, b)
        nbytes = arith.launch_bytes(run.kept_blocks, c["block"], width,
                                    c["reservoir_dim"], c["input_dim"],
                                    c["output_dim"], t, b)
        s, bound = arith.least_seconds(ops, nbytes, run.arith)
        total += s
        by[bound] = by.get(bound, 0.0) + s
    return total, max(by, key=by.get) if by else "none"


def device_idle_pct(run) -> float | None:
    """Share of the traced window in which no device operation ran."""
    if run.trace is None or run.window.seconds <= 0:
        return None
    busy = busy_ns(run.device_ops()) / 1e9
    return 100.0 * (1.0 - busy / run.window.seconds)
