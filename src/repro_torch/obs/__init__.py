"""End-to-end observability: metrics, request tracing, kernel events.

Off by default, and cheap when off: every instrumented site in the serve /
plan / kernel stack funnels through the module-level one-liners below
(:func:`inc`, :func:`observe`, :func:`span`, :func:`event`, ...), each of
which is a single global read plus a ``None`` check when
:func:`configure` has not been called.  The three sinks:

* :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters, gauges and
  mergeable fixed-bucket latency histograms (exact p50/p99/p999 from
  bucket counts), exported as Prometheus text or JSON;
* :class:`~repro_torch.obs.trace.Tracer` — structured spans (request
  lifecycle on the server clock; the one-shot request path from
  ``submit`` down to the rollout launch, and plan stages, on the wall
  clock) in a bounded flight recorder with JSONL export; each span names
  its parent;
* :class:`~repro_torch.obs.events.EventLog` — named, timestamped kernel
  build / set-up / cache-miss events.

Every timestamp of the wall clock, spans' and events' alike, is
``time.perf_counter`` seconds: the clock a profiler's device trace is
mapped onto, so a span and the device operations under it line up.

Typical session::

    from repro_torch import obs
    obs.configure()                       # all three sinks on
    ... serve traffic ...
    print(obs.metrics().prometheus_text())           # scrape payload
    print(obs.metrics().summary())                   # p50/p99/p999 view
    obs.tracer().export_jsonl("trace.jsonl")         # flight recorder
    assert obs.events().count("kernel_build") <= 1   # built at most once
    obs.disable()                         # back to zero-cost no-ops

A site that times a span only when tracing is on guards itself
explicitly, so that off it costs one global read and no clock read::

    tracer = obs.open_span("request.serve", t0, trace_id=tid)
    ...                                   # spans recorded here are children
    if tracer is not None:
        tracer.close(finish)

``configure`` is idempotent-by-replacement: each call installs fresh
sinks (a clean measurement window); ``disable`` detaches them.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any

from repro_torch.obs.events import Event, EventLog
from repro_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge,
                               Histogram, HistogramData, MetricsRegistry)
from repro_torch.obs.trace import Span, Tracer

__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "Counter",
    "Event",
    "EventLog",
    "Gauge",
    "Histogram",
    "HistogramData",
    "MetricsRegistry",
    "ObsState",
    "Span",
    "Tracer",
    "active",
    "configure",
    "disable",
    "enabled",
    "event",
    "events",
    "inc",
    "metrics",
    "new_trace_id",
    "observe",
    "open_span",
    "set_gauge",
    "span",
    "timed_span",
    "tracer",
]


@dataclasses.dataclass
class ObsState:
    """The installed sinks; any of the three may be individually off."""

    metrics: MetricsRegistry | None = None
    tracer: Tracer | None = None
    events: EventLog | None = None


_ACTIVE: ObsState | None = None


def configure(*, metrics: bool = True, tracing: bool = True,
              events: bool = True, namespace: str = "repro",
              trace_capacity: int = 4096,
              event_capacity: int = 2048) -> ObsState:
    """Install fresh sinks and enable instrumentation.  Returns the new
    state (also reachable via :func:`active` / the accessors)."""
    global _ACTIVE
    _ACTIVE = ObsState(
        metrics=MetricsRegistry(namespace=namespace) if metrics else None,
        tracer=Tracer(capacity=trace_capacity) if tracing else None,
        events=EventLog(capacity=event_capacity) if events else None)
    return _ACTIVE


def disable() -> None:
    """Detach every sink: instrumented sites return to no-ops."""
    global _ACTIVE
    _ACTIVE = None


def active() -> ObsState | None:
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


def metrics() -> MetricsRegistry | None:
    return None if _ACTIVE is None else _ACTIVE.metrics


def tracer() -> Tracer | None:
    return None if _ACTIVE is None else _ACTIVE.tracer


def events() -> EventLog | None:
    return None if _ACTIVE is None else _ACTIVE.events


# -- hot-path one-liners (no-ops unless the matching sink is installed) ------
def inc(name: str, amount: float = 1.0, **labels) -> None:
    st = _ACTIVE
    if st is not None and st.metrics is not None:
        st.metrics.inc(name, amount, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    st = _ACTIVE
    if st is not None and st.metrics is not None:
        st.metrics.set(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    st = _ACTIVE
    if st is not None and st.metrics is not None:
        st.metrics.observe(name, value, **labels)


def span(name: str, start: float, end: float | None = None, *,
         trace_id: str | None = None, clock: str = "wall",
         **attrs: Any) -> None:
    """Record one finished span (no-op without a tracer)."""
    st = _ACTIVE
    if st is not None and st.tracer is not None:
        st.tracer.record(name, start, end, trace_id=trace_id, clock=clock,
                         **attrs)


def open_span(name: str, start: float, *,
              trace_id: str | None = None) -> Tracer | None:
    """Open a wall span that started at ``start`` (``time.perf_counter``)
    on this thread's stack: the spans recorded until it closes are its
    children and inherit its ``trace_id``.  Returns the tracer to
    :meth:`~Tracer.close` it on, or ``None`` when tracing is off."""
    st = _ACTIVE
    if st is None or st.tracer is None:
        return None
    st.tracer.open(name, start, trace_id=trace_id)
    return st.tracer


def event(kind: str, ts: float | None = None, **fields: Any) -> None:
    st = _ACTIVE
    if st is not None and st.events is not None:
        st.events.record(kind, ts=ts, **fields)


def new_trace_id() -> str | None:
    """A fresh request trace id, or ``None`` when tracing is off (callers
    simply don't thread an id then)."""
    st = _ACTIVE
    if st is not None and st.tracer is not None:
        return st.tracer.new_trace_id()
    return None


@contextmanager
def timed_span(name: str, *, trace_id: str | None = None, **attrs: Any):
    """Wall-clock span context manager, open while its block runs; a
    plain passthrough when tracing is off (the clock is not even read).
    Not for a hot path: there, guard on :func:`open_span` instead."""
    st = _ACTIVE
    if st is None or st.tracer is None:
        yield
        return
    with st.tracer.span(name, trace_id=trace_id, **attrs):
        yield
