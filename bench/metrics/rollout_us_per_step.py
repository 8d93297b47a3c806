"""Kernel layer: device microseconds of ``rollout_kernel`` and
``readout_kernel`` (profiler) per step the launches rolled."""

from bench.readers import rollout_us_per_step


def read(run):
    return rollout_us_per_step(run)
