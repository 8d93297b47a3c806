"""The program's own spans beside the device trace: where a request's host
time holds the card idle.

The port records its one-shot request path while ``repro_torch.obs``
traces (``obs.configure(metrics=False, events=False)``): per
``ReservoirEngine.submit`` a root ``request.serve`` over
``engine.prepare``, ``rollout.launch`` and ``engine.sync``, all with the
request's trace id, on ``time.perf_counter``, the clock
:class:`bench.devtrace.DeviceTrace` maps the device's operations onto.
The reductions here take those spans as ``(name, start_ns, end_ns,
trace_id, parent)`` tuples (:func:`program_spans`) and the trace's
``(name, start_ns, end_ns)`` operations.  Each per-request reduction
returns ``None`` when the tracer dropped a span, or when a request does
not pair with exactly one ``rollout.launch`` span and one rollout kernel
that starts inside it, so a number is never read off a partial record.

One offset at the trace's start does not hold the device's timestamps
to the host clock for a whole window: on the H100 the profiler's device
times wandered up to ~9 ms from its host times within 20 s and came
back, so that a kernel read as starting before its own launch call.
:class:`LaunchTrace` keeps, for each rollout kernel, the host start of
the runtime call that launched it; :func:`reanchor` reads the clock's
error off the launches' latency (a kernel starts after its call) and
moves every device operation by it.  A kernel's duration and the sum of
a request's lead and tail need no anchor.
"""

from __future__ import annotations

import bisect
import collections
import statistics

from bench.devtrace import DeviceTrace
from bench.readers import ROLLOUT_KERNELS

__all__ = ["LAUNCH", "ROOT", "LaunchTrace", "attribute_innermost",
           "launch_enqueue_us", "program_spans", "reanchor", "requests",
           "submit_lead_us", "submit_tail_us"]

ROOT = "request.serve"
LAUNCH = "rollout.launch"


def _is_rollout(name: str) -> bool:
    return any(k in name for k in ROLLOUT_KERNELS)


class LaunchTrace(DeviceTrace):
    """:class:`DeviceTrace` that also keeps ``launches``: per rollout
    kernel, ``(kernel_start_ns, call_start_ns)``, the kernel's start and
    the host start of the runtime call that launched it (the profiler's
    correlation id), both on ``perf_counter_ns`` by the trace's offset."""

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
        ops, launches = [], []
        for e in dev:
            s = e.start_ns() - off
            ops.append((e.name(), s, s + e.duration_ns()))
            call = host.get(e.correlation_id())
            if _is_rollout(e.name()) and call is not None:
                launches.append((s, call.start_ns() - off))
        ops.sort(key=lambda o: o[1])
        self.ops, self.launches = ops, sorted(launches)


def reanchor(ops, launches, *, half: int = 12,
             bin_ns: int = 5000) -> tuple[list, dict]:
    """``ops`` moved onto the host clock launch by launch, and the
    clock error's range and quartiles (us).

    A launch's latency is its kernel's start less its call's start; its
    median over launches ``i - half`` to ``i + half`` follows the clock's
    error, which moves over seconds (one slow launch is latency, not
    error).  The error wanders off and comes back, so the level the
    rolling medians hold longest, their densest ``bin_ns`` bin, is the
    true latency; the error at launch ``i`` is its rolling median less
    that level.  Every operation moves by the error at the last rollout
    kernel to start at or before it; operations before the first keep
    the trace's own offset."""
    if not launches:
        return list(ops), {}
    lat = [k - c for k, c in launches]
    roll = [statistics.median(lat[max(0, i - half):i + half + 1])
            for i in range(len(lat))]
    bins = collections.Counter(r // bin_ns for r in roll)
    top = max(sorted(bins), key=bins.__getitem__)
    level = statistics.median(r for r in roll if r // bin_ns == top)
    err = [r - level for r in roll]
    starts = [k for k, _c in launches]
    out = []
    for name, s, e in ops:
        i = bisect.bisect_right(starts, s) - 1
        d = err[i] if i >= 0 else 0
        out.append((name, s - d, e - d))
    q = statistics.quantiles(err, n=4) if len(err) > 1 else [0, 0, 0]
    return out, {"latency_us": level / 1e3,
                 "error_us": [min(err) / 1e3, *(x / 1e3 for x in q),
                              max(err) / 1e3]}


def program_spans(tracer, lo: int, hi: int) -> list | None:
    """The tracer's wall spans that start in ``[lo, hi)`` (ns), as
    ``(name, start_ns, end_ns, trace_id, parent)`` on ``perf_counter_ns``,
    oldest first; ``None`` without a tracer or when it dropped any."""
    if tracer is None or tracer.dropped:
        return None
    out = []
    for s in tracer.spans():
        start = round(s.start * 1e9)
        if s.clock == "wall" and lo <= start < hi:
            out.append((s.name, start, round(s.end * 1e9), s.trace_id,
                        s.parent))
    return out


def requests(spans, ops) -> list | None:
    """``(root, launch, kernel)`` per root ``request.serve`` span, in
    time order: its one ``rollout.launch`` (same trace id) and the one
    rollout kernel that starts inside it; ``None`` if any root lacks
    either or has more than one, or there is no root."""
    if not spans:
        return None
    kernels = sorted((o for o in ops if _is_rollout(o[0])),
                     key=lambda o: o[1])
    starts = [k[1] for k in kernels]
    launches: dict = {}
    for s in spans:
        if s[0] == LAUNCH and s[3] is not None:
            launches.setdefault(s[3], []).append(s)
    roots = sorted((s for s in spans if s[0] == ROOT and s[4] is None),
                   key=lambda s: s[1])
    out = []
    for r in roots:
        i = bisect.bisect_left(starts, r[1])
        j = bisect.bisect_right(starts, r[2])
        mine = launches.get(r[3], []) if r[3] is not None else []
        if j - i != 1 or len(mine) != 1:
            return None
        out.append((r, mine[0], kernels[i]))
    return out or None


def _mean_us(spans, ops, part) -> float | None:
    reqs = None if spans is None else requests(spans, ops)
    if reqs is None:
        return None
    return sum(part(*q) for q in reqs) / len(reqs) / 1e3


def submit_lead_us(spans, ops) -> float | None:
    """Mean over requests of their rollout kernel's device start less
    their ``request.serve`` start: the card idle before the work."""
    return _mean_us(spans, ops, lambda r, _l, k: k[1] - r[1])


def submit_tail_us(spans, ops) -> float | None:
    """Mean over requests of their ``request.serve`` end less their
    rollout kernel's device end: the card idle after the work."""
    return _mean_us(spans, ops, lambda r, _l, k: r[2] - k[2])


def launch_enqueue_us(spans, ops) -> float | None:
    """Mean duration of the requests' ``rollout.launch`` spans: the
    kernels layer's host time from its entry to the launch call's
    return."""
    return _mean_us(spans, ops, lambda _r, la, _k: la[2] - la[1])


def attribute_innermost(gaps, spans) -> dict:
    """Nanoseconds of ``gaps`` by the innermost span running through
    them.

    ``spans`` are tuples whose first three fields are ``(name, start_ns,
    end_ns)``: the benchmark's spans around its calls and the program's
    inside them, nested.  Where spans overlap, the one that started last
    is the innermost; a stretch no span covers is the benchmark's own
    loop (``"harness"``).  The totals are the gaps' lengths."""
    events = sorted((t, kind, -s[2] if kind else 0, i)
                    for i, s in enumerate(spans) if s[2] > s[1]
                    for t, kind in ((s[1], 1), (s[2], 0)))
    times, names, active = [], [], []
    for t, kind, _, i in events:
        if kind:
            active.append(i)
        else:
            active.remove(i)
        name = spans[active[-1]][0] if active else "harness"
        if times and times[-1] == t:
            names[-1] = name
        else:
            times.append(t)
            names.append(name)
    out: dict = {}
    for g0, g1 in gaps:
        k = bisect.bisect_right(times, g0) - 1
        t = g0
        while t < g1:
            name = names[k] if k >= 0 else "harness"
            end = min(times[k + 1], g1) if k + 1 < len(times) else g1
            if end > t:
                out[name] = out.get(name, 0) + end - t
            t = end
            k += 1
    return out
