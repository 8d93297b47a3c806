"""Device: share of the traced window with no device operation running
(the union of the profiler's operation intervals)."""

from bench.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
