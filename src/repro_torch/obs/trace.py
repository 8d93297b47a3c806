"""Structured span tracing into a bounded in-memory flight recorder.

One :class:`Tracer` holds a fixed-capacity ring of :class:`Span` records —
enough history to reconstruct *why* the last N requests were slow (queue
wait vs. chunk stall vs. an autotune recompile) without growing without
bound under sustained traffic.  Spans carry:

* ``name``      — the stage (``request.queued``, ``scheduler.chunk``,
  ``engine.dispatch``, ``autotune.trial``, ...);
* ``trace_id``  — threaded from ``SubmitSpec.trace_id`` through every
  stage a request touches, so one grep over the JSONL dump reassembles a
  request's whole lifecycle;
* ``clock``     — ``"wall"`` (``time.perf_counter``) or ``"server"``
  (the scheduler's virtual clock): the two timelines must never be
  compared directly, so every span says which one it is on.

``export_jsonl`` dumps the recorder for post-incident analysis — one JSON
object per line, oldest first.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import time
from contextlib import contextmanager
from typing import Any

__all__ = ["Span", "Tracer"]


@dataclasses.dataclass(slots=True)
class Span:
    """One timed stage.  ``start == end`` marks an instant event.

    A plain (slotted, non-frozen) dataclass: span construction sits on
    the serve hot path, and frozen's ``object.__setattr__`` per field
    roughly doubles its cost."""

    name: str
    start: float
    end: float
    trace_id: str | None = None
    clock: str = "wall"
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.end - self.start

    def as_dict(self) -> dict:
        return {"name": self.name, "start": self.start, "end": self.end,
                "duration_s": self.duration_s, "trace_id": self.trace_id,
                "clock": self.clock, "attrs": self.attrs}


class Tracer:
    """Bounded span recorder ("flight recorder").

    Appends are O(1); once ``capacity`` is reached the oldest span falls
    off (``dropped`` counts how many), so the recorder's memory is fixed
    no matter how long the server runs.
    """

    def __init__(self, capacity: int = 4096):
        assert capacity >= 1
        self.capacity = capacity
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._ids = itertools.count(1)

    def new_trace_id(self) -> str:
        """A process-unique request id (``t-000001``, ...)."""
        return f"t-{next(self._ids):06d}"

    def record(self, name: str, start: float, end: float | None = None, *,
               trace_id: str | None = None, clock: str = "wall",
               **attrs: Any) -> Span:
        """Record one finished span (``end`` defaults to ``start`` — an
        instant event)."""
        span = Span(name=name, start=float(start),
                    end=float(start if end is None else end),
                    trace_id=trace_id, clock=clock, attrs=attrs)
        if len(self._spans) == self.capacity:
            self.dropped += 1
        self._spans.append(span)
        return span

    @contextmanager
    def span(self, name: str, *, trace_id: str | None = None, **attrs: Any):
        """Wall-clock context manager: times the enclosed block."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, t0, time.perf_counter(), trace_id=trace_id,
                        clock="wall", **attrs)

    def spans(self, *, name: str | None = None,
              trace_id: str | None = None) -> list:
        """Recorded spans, oldest first, optionally filtered."""
        return [s for s in self._spans
                if (name is None or s.name == name)
                and (trace_id is None or s.trace_id == trace_id)]

    def __len__(self) -> int:
        return len(self._spans)

    def clear(self) -> None:
        self._spans.clear()

    def to_jsonl(self) -> str:
        return "".join(json.dumps(s.as_dict(), sort_keys=True) + "\n"
                       for s in self._spans)

    def export_jsonl(self, path) -> int:
        """Dump the recorder to ``path`` (one span per line, oldest
        first); returns the number of spans written."""
        text = self.to_jsonl()
        with open(path, "w") as f:
            f.write(text)
        return len(self._spans)
