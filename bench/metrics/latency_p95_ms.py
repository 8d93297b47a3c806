"""95th percentile over every request due in the window, from its due
time to its predictions on the host (host clock)."""

from bench.arith import percentile


def read(run):
    lat = run.window.latencies_s()
    return 1e3 * percentile(lat, 95) if lat else None
