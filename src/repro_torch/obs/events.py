"""Build/launch event log: every kernel build is a named, timestamped fact.

Steady-state serving must never build: the CUDA rollout kernels compile
once per process, the batcher owns one static pool shape, and
``engine_for`` / ``plan_for`` memoize their expensive steps.  When that
property breaks — a cache key regresses, a build directory is wiped under
a running server — the only symptom would be a mysterious latency spike.
This log turns it into evidence: the instrumented build, set-up and
cache-miss sites emit an :class:`Event` (``kind`` plus free-form fields).
A launch is no event: ``kernel_launches_total`` counts launches, and the
``rollout.launch`` span (:mod:`repro_torch.obs.trace`) times each one.

Well-known kinds emitted by the instrumented sites:

====================  ======================================================
``kernel_build``      the rollout kernels compiled (or loaded) — once
``rollout_setup``     an engine's first rollout of a new shape key
``engine_build``      a ReservoirEngine constructed
``engine_cache_miss`` ``engine_for`` built instead of reusing
``plan_lowering``     ``plan_for`` lowered a matrix (cache miss)
``specialize``        ``specialize_rollout`` built a rollout program
``rollout_grid``      a rollout table's grid and shares packed for a device
====================  ======================================================
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Any

__all__ = ["Event", "EventLog"]


@dataclasses.dataclass(frozen=True)
class Event:
    """One named, timestamped occurrence (``ts`` is ``time.perf_counter``
    seconds, the clock of the wall spans)."""

    ts: float
    kind: str
    fields: dict

    def as_dict(self) -> dict:
        return {"ts": self.ts, "kind": self.kind, **self.fields}


class EventLog:
    """Bounded event ring with per-kind lifetime counters.

    The ring holds the last ``capacity`` events (the incident record);
    ``counts`` keeps exact per-kind totals for the whole process lifetime
    even after old events fall off, so "how many retraces, ever" never
    under-reports.
    """

    def __init__(self, capacity: int = 2048):
        assert capacity >= 1
        self.capacity = capacity
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self.counts: collections.Counter = collections.Counter()
        self.dropped = 0

    def record(self, kind: str, ts: float | None = None,
               **fields: Any) -> Event:
        ev = Event(ts=time.perf_counter() if ts is None else float(ts),
                   kind=kind, fields=fields)
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)
        self.counts[kind] += 1
        return ev

    def events(self, kind: str | None = None) -> list:
        """Buffered events oldest-first, optionally one kind."""
        return [e for e in self._events if kind is None or e.kind == kind]

    def count(self, kind: str) -> int:
        """Lifetime count of ``kind`` (survives ring eviction)."""
        return self.counts[kind]

    def __len__(self) -> int:
        return len(self._events)

    def drain(self, kind: str | None = None) -> list:
        """Return-and-forget: the buffered events (optionally one kind)
        are removed from the ring so a steady-state window can be
        measured as "events recorded since the last drain".  Lifetime
        ``counts`` are untouched."""
        if kind is None:
            out = list(self._events)
            self._events.clear()
            return out
        out, keep = [], []
        for e in self._events:
            (out if e.kind == kind else keep).append(e)
        self._events.clear()
        self._events.extend(keep)
        return out

    def to_jsonl(self) -> str:
        return "".join(json.dumps(e.as_dict(), sort_keys=True, default=str)
                       + "\n" for e in self._events)

    def export_jsonl(self, path) -> int:
        text = self.to_jsonl()
        with open(path, "w") as f:
            f.write(text)
        return len(self._events)
