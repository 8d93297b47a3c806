"""The measured window: a mix's requests driven through the program.

:func:`drive_engine` is one closed-loop client calling
``ReservoirEngine.submit`` at batch 1 and copying each answer's
predictions to the host before it sends the next request.  Requests are
due from the window's open until ``seconds`` later; the one in flight at
the close is answered after it, and the window runs to that answer.  All
times are ``time.perf_counter_ns``.  With ``spans`` (a list) the loop
also records the benchmark's own spans around each call into the program.
"""

from __future__ import annotations

import dataclasses
import time

__all__ = ["Window", "drive_engine"]

_ns = time.perf_counter_ns


@dataclasses.dataclass
class Window:
    t_open: int
    t_close: int = 0                 # when the last request could be due
    t_last: int = 0                  # the close, or the last answer after
    due: dict = dataclasses.field(default_factory=dict)     # k -> t_due
    lengths: dict = dataclasses.field(default_factory=dict)  # k -> steps
    done: dict = dataclasses.field(default_factory=dict)    # k -> t_done
    answers: dict = dataclasses.field(default_factory=dict)  # k -> (T, O)
    launches: list = dataclasses.field(default_factory=list)  # (T, B) each
    spans: list | None = None        # (name, t0, t1) when tracing

    @property
    def seconds(self) -> float:
        """The window's length: from its open to its close or, if later,
        the last due request's answer."""
        return (self.t_last - self.t_open) / 1e9

    def latencies_s(self) -> list:
        return [(self.done[k] - t) / 1e9 for k, t in self.due.items()
                if k in self.done]

    @property
    def answered_steps(self) -> int:
        return sum(self.lengths[k] for k in self.done)


def _span(spans, name, t0, t1):
    if spans is not None:
        spans.append((name, t0, t1))


def drive_engine(engine, traffic, seconds: float, *, spans=None) -> Window:
    from repro_torch.serve import SubmitSpec
    w = Window(t_open=_ns(), spans=spans)
    end = w.t_open + int(seconds * 1e9)
    k = 0
    while True:
        t_due = _ns()
        if t_due >= end:
            break
        u = traffic.inputs(k)
        spec = SubmitSpec(u)
        t1 = _ns()
        res = engine.submit(spec)
        t2 = _ns()
        y = res.preds.cpu().numpy()
        t3 = _ns()
        w.due[k], w.lengths[k] = t_due, len(u)
        w.done[k], w.answers[k] = t3, y
        w.launches.append((len(u), 1))
        _span(spans, "generator", t_due, t1)
        _span(spans, "submit", t1, t2)
        _span(spans, "copy", t2, t3)
        k += 1
    w.t_close = end
    w.t_last = max(max(w.done.values(), default=end), end)
    return w
