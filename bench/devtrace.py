"""The device trace of a traced run and what is read from it.

``torch.profiler`` records the device's operations (kernels, copies,
sets) over the window with CUDA activity only, so the host pays CUPTI's
cost per launch and nothing per PyTorch operator.  The events are read
straight from the profiler's results, without building its per-operator
tables.  Their timestamps are on the system clock; the benchmark's host
spans are on ``time.perf_counter_ns``, so both are put on one clock by an
offset taken when the trace starts.

The functions below the class are plain interval arithmetic over
``(name, start_ns, end_ns)`` tuples, for the per-layer readers.
"""

from __future__ import annotations

import time

__all__ = ["DeviceTrace", "attribute_gaps", "busy_ns", "idle_gaps",
           "op_totals", "clip"]


def _clock_offset() -> int:
    """System clock minus ``perf_counter_ns``, from the closest of a few
    paired readings."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        s = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, s - (a + b) // 2)
    return best[1]


class DeviceTrace:
    """Device operations between :meth:`start` and :meth:`stop`, as
    ``(name, start_ns, end_ns)`` on the ``perf_counter_ns`` clock.

    The clocks are tied by a marker: one fill kernel launched right after
    the trace starts, its launch call bracketed on the host clock; the
    profiler's record of that launch call sits inside the bracket.  Where
    the record is missing, the system clock's offset stands in.
    ``offset_check_us`` is how far the two offsets differ."""

    def __init__(self, device):
        self.device = device
        self.ops: list = []
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self.offset_ns = _clock_offset()
        mark = torch.empty(1, device=self.device)
        torch.cuda.synchronize(self.device)
        a = time.perf_counter_ns()
        mark.fill_(1.0)
        b = time.perf_counter_ns()
        torch.cuda.synchronize(self.device)
        self._mark = (a + b) // 2

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize(self.device)
        self._prof.stop()
        events = list(self._prof.profiler.kineto_results.events())
        self._prof = None
        dev = [e for e in events if str(e.device_type()).endswith("CUDA")]
        host = {e.correlation_id(): e for e in events
                if not str(e.device_type()).endswith("CUDA")}
        first = min(dev, key=lambda e: e.start_ns(), default=None)
        off = self.offset_ns
        self.offset_check_us = None
        if first is not None and first.correlation_id() in host:
            marked = host[first.correlation_id()].start_ns() - self._mark
            self.offset_check_us = (marked - off) / 1e3
            off = marked
        ops = []
        for e in dev:
            s = e.start_ns() - off
            ops.append((e.name(), s, s + e.duration_ns()))
        ops.sort(key=lambda o: o[1])
        self.ops = ops


def clip(ops, lo: int, hi: int) -> list:
    """``ops`` cut to the interval ``[lo, hi)``."""
    return [(n, max(s, lo), min(e, hi)) for n, s, e in ops
            if e > lo and s < hi]


def busy_ns(ops) -> int:
    """Length of the union of the operations' intervals."""
    total, cur_s, cur_e = 0, None, None
    for _n, s, e in sorted(ops, key=lambda o: o[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(ops, lo: int, hi: int) -> list:
    """The ``(start, end)`` stretches of ``[lo, hi)`` with no operation."""
    gaps, t = [], lo
    for _n, s, e in sorted(clip(ops, lo, hi), key=lambda o: o[1]):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def attribute_gaps(gaps, spans) -> dict:
    """Nanoseconds of ``gaps`` by the host span running through them.

    ``spans`` are the benchmark's ``(name, start_ns, end_ns)`` spans
    around its calls, one after another on one thread; a stretch that no
    span covers is the benchmark's own loop (``"harness"``)."""
    spans = sorted(spans, key=lambda s: s[1])
    out: dict = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(spans) and spans[j][2] <= g0:
            j += 1
        t, i = g0, j
        while t < g1:
            while i < len(spans) and spans[i][2] <= t:
                i += 1
            if i < len(spans) and spans[i][1] <= t:
                end = min(spans[i][2], g1)
                out[spans[i][0]] = out.get(spans[i][0], 0) + end - t
                t = end
                i += 1
            else:
                end = g1 if i >= len(spans) else min(spans[i][1], g1)
                out["harness"] = out.get("harness", 0) + end - t
                t = end
    return out


def op_totals(ops) -> dict:
    """Summed device nanoseconds by operation name."""
    out: dict = {}
    for n, s, e in ops:
        out[n] = out.get(n, 0) + (e - s)
    return out
