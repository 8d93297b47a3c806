"""Structured span tracing into a bounded in-memory flight recorder.

One :class:`Tracer` holds a fixed-capacity ring of :class:`Span` records —
enough history to reconstruct *why* the last N requests were slow (queue
wait vs. chunk stall vs. an autotune recompile) without growing without
bound under sustained traffic.  Spans carry:

* ``name``      — the stage.  On the one-shot request path
  (``ReservoirEngine.submit``) one tree per request: ``request.serve``
  (the root, from ``submit``'s entry to its return) over
  ``engine.prepare`` (inputs and x0 onto the device), ``rollout.launch``
  (the kernels layer's entry for one rollout to the return of the
  launch call: operand checks, grid, allocations and the enqueue on a
  card; the plain twin's whole call on a CPU tensor) and
  ``engine.sync`` (the device synchronisation after the launch).
  ``rollout.launch`` and ``engine.sync`` also fire on ``run_segment``
  and the scheduler's chunks, there with no root.  Elsewhere:
  ``request.enqueue`` / ``request.queued`` / ``request.first_output`` /
  ``request.serve`` / ``scheduler.chunk`` (the server, on its clock),
  ``plan.lower``, ``plan.specialize``, ``autotune.trial``,
  ``registry.publish``;
* ``trace_id``  — threaded from ``SubmitSpec.trace_id`` through every
  stage a request touches, so one grep over the JSONL dump reassembles a
  request's whole lifecycle;
* ``parent``    — the name of the span that was open when this one was
  recorded (``None`` at a root).  :meth:`Tracer.open` puts a span on the
  calling thread's stack of open spans; every span recorded until its
  :meth:`Tracer.close` takes it as ``parent`` and inherits its
  ``trace_id``, so a layer below joins a request's trace with no
  argument of its own;
* ``clock``     — ``"wall"`` (``time.perf_counter`` seconds, the clock a
  profiler's device trace can be mapped onto) or ``"server"`` (the
  scheduler's virtual clock): the two timelines must never be compared
  directly, so every span says which one it is on.

``export_jsonl`` dumps the recorder for post-incident analysis — one JSON
object per line, oldest first.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import threading
import time
from contextlib import contextmanager
from typing import Any

__all__ = ["Span", "Tracer"]


@dataclasses.dataclass(slots=True)
class Span:
    """One timed stage.  ``start == end`` marks an instant event.
    :meth:`Tracer.spans` builds these from the ring's tuples, whose
    fields are in this order."""

    name: str
    start: float
    end: float
    trace_id: str | None = None
    clock: str = "wall"
    attrs: dict = dataclasses.field(default_factory=dict)
    parent: str | None = None

    @property
    def duration_s(self) -> float:
        return self.end - self.start

    def as_dict(self) -> dict:
        return {"name": self.name, "start": self.start, "end": self.end,
                "duration_s": self.duration_s, "trace_id": self.trace_id,
                "clock": self.clock, "attrs": self.attrs,
                "parent": self.parent}


class _OpenSpans(threading.local):
    """Each thread's stack of open spans, ``(name, trace_id, start)``."""

    def __init__(self):
        self.stack = []


class Tracer:
    """Bounded span recorder ("flight recorder").

    Appends are O(1); once ``capacity`` is reached the oldest span falls
    off (``dropped`` counts how many), so the recorder's memory is fixed
    no matter how long the server runs.  The ring holds each span as a
    tuple of :class:`Span`'s fields, made a :class:`Span` when read: a
    request's four spans cost a few tuples on the serve path.
    """

    def __init__(self, capacity: int = 4096):
        assert capacity >= 1
        self.capacity = capacity
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._appended = 0            # since the last clear()
        self._dropped_before = 0      # dropped before the last clear()
        self._ids = itertools.count(1)
        self._open = _OpenSpans()

    @property
    def dropped(self) -> int:
        """Spans that fell off the ring, over the tracer's life."""
        return self._dropped_before + max(0, self._appended - self.capacity)

    def new_trace_id(self) -> str:
        """A process-unique request id (``t-000001``, ...)."""
        return f"t-{next(self._ids):06d}"

    def record(self, name: str, start: float, end: float | None = None, *,
               trace_id: str | None = None, clock: str = "wall",
               **attrs: Any) -> None:
        """Record one finished span (``end`` defaults to ``start`` — an
        instant event).  While a span is open on this thread the new one
        takes it as ``parent`` and, given no ``trace_id``, its id."""
        if end is None:
            end = start
        stack = self._open.stack
        if stack:
            parent, open_id, _ = stack[-1]
            self._spans.append((name, start, end, trace_id or open_id,
                                clock, attrs, parent))
        else:
            self._spans.append((name, start, end, trace_id, clock, attrs,
                                None))
        self._appended += 1

    def open(self, name: str, start: float, *,
             trace_id: str | None = None) -> None:
        """Open a wall span that started at ``start`` on this thread's
        stack (given no ``trace_id``, it takes the id of the span open
        below it); spans recorded until :meth:`close` are its
        children."""
        stack = self._open.stack
        if stack:
            trace_id = trace_id or stack[-1][1]
        stack.append((name, trace_id, start))

    def close(self, end: float | None = None, **attrs: Any) -> None:
        """Close and record the span :meth:`open` last opened on this
        thread (``end`` defaults to now)."""
        stack = self._open.stack
        name, trace_id, start = stack.pop()
        self._spans.append((name, start,
                            time.perf_counter() if end is None else end,
                            trace_id, "wall", attrs,
                            stack[-1][0] if stack else None))
        self._appended += 1

    @contextmanager
    def span(self, name: str, *, trace_id: str | None = None, **attrs: Any):
        """Wall-clock context manager: times the enclosed block, open
        while it runs (the spans recorded inside are its children)."""
        self.open(name, time.perf_counter(), trace_id=trace_id)
        try:
            yield
        finally:
            self.close(**attrs)

    def spans(self, *, name: str | None = None,
              trace_id: str | None = None) -> list:
        """Recorded spans, oldest first, optionally filtered."""
        return [Span(*f) for f in self._spans
                if (name is None or f[0] == name)
                and (trace_id is None or f[3] == trace_id)]

    def __len__(self) -> int:
        return len(self._spans)

    def clear(self) -> None:
        self._dropped_before = self.dropped
        self._appended = 0
        self._spans.clear()

    def to_jsonl(self) -> str:
        return "".join(json.dumps(s.as_dict(), sort_keys=True) + "\n"
                       for s in self.spans())

    def export_jsonl(self, path) -> int:
        """Dump the recorder to ``path`` (one span per line, oldest
        first); returns the number of spans written."""
        text = self.to_jsonl()
        with open(path, "w") as f:
            f.write(text)
        return len(self._spans)
