"""Counters, gauges and fixed-bucket latency histograms with exports.

The paper's claim is a latency story, and a latency story needs tails:
``ServeStats`` accumulates sums and counts, so it can quote *means* but
not the p99/p999 a sustained-load SLO is written against.  This module is
the percentile half of the telemetry stack:

* every metric family holds one series per label set (``tenant=``,
  ``shard=``, ...), so a multi-tenant sharded server gets per-tenant and
  per-shard breakdowns for free;
* :class:`Histogram` series use *fixed* bucket boundaries, which makes
  them mergeable by plain addition — per-shard histograms merged give
  exactly the percentiles of one histogram fed the union of the samples
  (the property test in ``tests/test_obs.py`` pins this), mirroring how
  ``ServeStats.merge`` sums its counters across shards;
* :meth:`MetricsRegistry.prometheus_text` renders the standard text
  exposition format (scrape it, or dump it next to an incident trace)
  and :meth:`MetricsRegistry.to_json` / :meth:`MetricsRegistry.from_json`
  round-trip the registry losslessly.

Percentiles are computed from bucket counts by nearest rank: the reported
value is the upper bound of the bucket the rank falls in (the recorded
maximum for the overflow bucket), so a merged histogram and a union
histogram can never disagree.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
from typing import Iterable, Mapping, Sequence

__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramData",
    "MetricsRegistry",
]

# 1-2-5 per decade from 1 us to 100 s: wide enough for a virtual-clock
# chunk (tens of us) and a queue wait under sustained load (seconds),
# fine enough that nearest-rank bucket percentiles stay meaningful.
DEFAULT_LATENCY_BUCKETS = tuple(
    float(f"{m}e{e}") for e in range(-6, 2) for m in (1, 2, 5)) + (100.0,)


def _labelkey(labels: Mapping[str, object]) -> tuple:
    if not labels:
        return ()
    if len(labels) == 1:
        [(k, v)] = labels.items()
        return ((str(k), str(v)),)
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _labelstr(key: tuple, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    """Prometheus-style number: integers render bare, floats repr()."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


@dataclasses.dataclass
class HistogramData:
    """One histogram series: fixed-bucket counts + sum/count/max.

    ``counts[i]`` counts observations ``<= buckets[i]``-and-above the
    previous bound; ``counts[-1]`` is the +Inf overflow bucket.  All
    fields are additive (``vmax`` maxes), which is what makes
    :meth:`merge` exact.
    """

    buckets: tuple
    counts: list = None
    total: int = 0
    sum: float = 0.0
    vmax: float = 0.0

    def __post_init__(self):
        self.buckets = tuple(float(b) for b in self.buckets)
        assert list(self.buckets) == sorted(set(self.buckets)), \
            "bucket bounds must be strictly increasing"
        if self.counts is None:
            self.counts = [0] * (len(self.buckets) + 1)
        assert len(self.counts) == len(self.buckets) + 1

    def observe(self, value: float) -> None:
        v = float(value)
        self.total += 1
        self.sum += v
        if self.total == 1 or v > self.vmax:
            self.vmax = v
        # first bound >= v (== the overflow slot when v beats them all)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1

    @staticmethod
    def merge(parts: "Iterable[HistogramData]") -> "HistogramData":
        """Sum bucket counts across series (identical bucket layouts
        required) — percentiles of the merge equal percentiles of the
        union of the underlying samples, exactly."""
        parts = list(parts)
        assert parts, "nothing to merge"
        base = HistogramData(buckets=parts[0].buckets)
        for p in parts:
            assert p.buckets == base.buckets, \
                f"bucket layouts differ: {p.buckets} vs {base.buckets}"
            base.total += p.total
            base.sum += p.sum
            base.vmax = max(base.vmax, p.vmax)
            for i, c in enumerate(p.counts):
                base.counts[i] += c
        return base

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile from bucket counts (0.0 when empty).

        Returns the upper bound of the bucket the rank lands in; the
        overflow bucket answers with the recorded maximum so the tail is
        never reported as infinity.
        """
        if self.total == 0:
            return 0.0
        rank = max(1, math.ceil(p / 100.0 * self.total))
        seen = 0
        for i, c in enumerate(self.counts[:-1]):
            seen += c
            if seen >= rank:
                return self.buckets[i]
        return self.vmax

    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else 0.0

    def as_dict(self) -> dict:
        return {"counts": list(self.counts), "total": self.total,
                "sum": self.sum, "vmax": self.vmax}


class _Family:
    """Shared per-label-set series bookkeeping for all metric types."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict = {}

    @property
    def series(self) -> dict:
        return self._series

    def labelsets(self) -> list:
        return sorted(self._series)


class Counter(_Family):
    """Monotonic per-label-set count (``requests_total{tenant="A"}``)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _labelkey(labels)
        self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        if labels:
            return float(self._series.get(_labelkey(labels), 0.0))
        return float(sum(self._series.values()))


class Gauge(_Family):
    """Point-in-time value per label set (``slot_occupancy{shard="0"}``)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[_labelkey(labels)] = float(value)

    def value(self, **labels) -> float:
        return float(self._series.get(_labelkey(labels), 0.0))


class Histogram(_Family):
    """Fixed-bucket histogram family; one :class:`HistogramData` per
    label set, and label-free reads merge every series."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(float(b) for b in buckets)

    def observe(self, value: float, **labels) -> None:
        key = _labelkey(labels)
        data = self._series.get(key)
        if data is None:
            data = self._series[key] = HistogramData(buckets=self.buckets)
        data.observe(value)

    def data(self, **labels) -> HistogramData:
        """The series for ``labels`` — or, with no labels, the merge of
        every series (empty histogram when nothing was observed)."""
        if labels:
            return self._series.get(_labelkey(labels)) \
                or HistogramData(buckets=self.buckets)
        if not self._series:
            return HistogramData(buckets=self.buckets)
        return HistogramData.merge(self._series.values())

    def percentile(self, p: float, **labels) -> float:
        return self.data(**labels).percentile(p)

    def count(self, **labels) -> int:
        return self.data(**labels).total


class MetricsRegistry:
    """Named metric families behind one export surface.

    Families auto-create on first use (``inc``/``set``/``observe``), so
    instrumentation sites never have to pre-declare; ``declare_*`` pins
    help text and custom buckets up front.  A name maps to exactly one
    type — observing a counter is a bug and raises.
    """

    def __init__(self, namespace: str = "repro"):
        self.namespace = namespace
        self._families: dict = {}

    # -- declaration / access ------------------------------------------------
    def _family(self, name: str, cls, **kwargs):
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = cls(name, **kwargs)
        elif not isinstance(fam, cls):
            raise TypeError(
                f"metric {name!r} is a {fam.kind}, not a {cls.kind}")
        return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._family(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._family(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._family(name, Histogram, help=help, buckets=buckets)

    def get(self, name: str):
        return self._families.get(name)

    def families(self) -> list:
        return [self._families[n] for n in sorted(self._families)]

    # -- one-liner record surface (hot path: the serve loop calls these
    # several times per request, so the existing-family case skips the
    # declaration helpers and goes straight to the series update) -----------
    def inc(self, name: str, amount: float = 1.0, **labels) -> None:
        fam = self._families.get(name)
        if fam is None or fam.__class__ is not Counter:
            fam = self.counter(name)
        fam.inc(amount, **labels)

    def set(self, name: str, value: float, **labels) -> None:
        fam = self._families.get(name)
        if fam is None or fam.__class__ is not Gauge:
            fam = self.gauge(name)
        fam.set(value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        fam = self._families.get(name)
        if fam is None or fam.__class__ is not Histogram:
            fam = self.histogram(name)
        fam.observe(value, **labels)

    # -- exports -------------------------------------------------------------
    def prometheus_text(self) -> str:
        """The standard text exposition format (one scrape payload)."""
        lines = []
        ns = self.namespace
        for fam in self.families():
            full = f"{ns}_{fam.name}" if ns else fam.name
            if fam.help:
                lines.append(f"# HELP {full} {fam.help}")
            lines.append(f"# TYPE {full} {fam.kind}")
            if isinstance(fam, Histogram):
                for key in fam.labelsets():
                    d = fam.series[key]
                    cum = 0
                    for b, c in zip(d.buckets, d.counts):
                        cum += c
                        le = 'le="' + _fmt(b) + '"'
                        lines.append(
                            f"{full}_bucket{_labelstr(key, le)} {cum}")
                    inf = 'le="+Inf"'
                    lines.append(
                        f"{full}_bucket{_labelstr(key, inf)} {d.total}")
                    lines.append(f"{full}_sum{_labelstr(key)} {_fmt(d.sum)}")
                    lines.append(f"{full}_count{_labelstr(key)} {d.total}")
            else:
                # counters get the conventional _total suffix unless the
                # author already named them with it
                suffix = ("_total" if isinstance(fam, Counter)
                          and not fam.name.endswith("_total") else "")
                for key in fam.labelsets():
                    lines.append(f"{full}{suffix}{_labelstr(key)} "
                                 f"{_fmt(fam.series[key])}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> dict:
        """Lossless snapshot: :meth:`from_json` of it renders the exact
        same Prometheus text."""
        fams = []
        for fam in self.families():
            rec = {"name": fam.name, "kind": fam.kind, "help": fam.help}
            if isinstance(fam, Histogram):
                rec["buckets"] = list(fam.buckets)
                rec["series"] = [
                    {"labels": dict(key), **fam.series[key].as_dict()}
                    for key in fam.labelsets()]
            else:
                rec["series"] = [{"labels": dict(key),
                                  "value": fam.series[key]}
                                 for key in fam.labelsets()]
            fams.append(rec)
        return {"namespace": self.namespace, "metrics": fams}

    @classmethod
    def from_json(cls, data: dict) -> "MetricsRegistry":
        reg = cls(namespace=data.get("namespace", "repro"))
        for rec in data.get("metrics", ()):
            name, kind = rec["name"], rec["kind"]
            if kind == "histogram":
                fam = reg.histogram(name, help=rec.get("help", ""),
                                    buckets=rec["buckets"])
                for s in rec["series"]:
                    fam.series[_labelkey(s["labels"])] = HistogramData(
                        buckets=fam.buckets, counts=list(s["counts"]),
                        total=int(s["total"]), sum=float(s["sum"]),
                        vmax=float(s["vmax"]))
            else:
                fam = (reg.counter if kind == "counter" else reg.gauge)(
                    name, help=rec.get("help", ""))
                for s in rec["series"]:
                    fam.series[_labelkey(s["labels"])] = float(s["value"])
        return reg

    def save_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    def summary(self) -> dict:
        """Compact human-readable snapshot: counters/gauges by value,
        histograms by count/mean/p50/p99/p999 (merged across labels)."""
        out: dict = {}
        for fam in self.families():
            if isinstance(fam, Histogram):
                d = fam.data()
                out[fam.name] = {
                    "count": d.total, "mean": d.mean,
                    "p50": d.percentile(50.0), "p99": d.percentile(99.0),
                    "p999": d.percentile(99.9)}
            else:
                out[fam.name] = fam.value()
        return out
