"""Kernel layer: the least time the window's rollout launches need (the
larger of operations over the peak of the configuration's arithmetic and
bytes over HBM bandwidth, per launch) over their device time, in %."""

from bench.arith import roofline_pct
from bench.readers import rollout_device_ns, rollout_least_s


def read(run):
    ns = rollout_device_ns(run)
    if ns is None:
        return None
    least, _bound = rollout_least_s(run)
    return roofline_pct(least, ns / 1e9)
