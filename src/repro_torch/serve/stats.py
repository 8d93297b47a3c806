"""Serving telemetry: throughput, latency and padding-efficiency counters.

The unit of account is the *reservoir step* (one Eq.-1 update for one
sequence) — the figure the paper's latency numbers are quoted in.  Padded
steps (bucket padding in time, batch padding to the bucket size) are
tracked separately so the engine can report how much of its raw throughput
is doing useful work.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class ServeStats:
    calls: int = 0                 # engine invocations (microbatches)
    deferred_calls: int = 0        # calls timed dispatch-side only (the
    #                                zero-copy serve loop defers the host
    #                                sync to retirement, so ``seconds``
    #                                under-counts for these — read
    #                                throughput from the scheduler clock)
    sequences: int = 0             # sequences rolled (incl. padding rows)
    steps_real: int = 0            # steps requested by callers
    steps_padded: int = 0          # steps actually executed
    seconds: float = 0.0           # wall time spent in rollouts
    latency_ewma_s: float = 0.0    # smoothed per-call latency
    # continuous-batching telemetry (AsyncReservoirServer), all on the
    # server's clock: queue waits, time-to-first-prediction, and how full
    # the slot pool ran.
    enqueued: int = 0              # requests submitted to the queue
    admitted: int = 0              # requests seated in a slot
    completed: int = 0             # requests fully served
    timed_out: int = 0             # queued requests dropped past deadline
    rejected: int = 0              # submissions refused outright by the
    #                                admission policy (bounded queue /
    #                                fairness) — never entered the queue
    shed: int = 0                  # submissions refused because the
    #                                estimated queue delay already blows
    #                                the request's deadline
    retries: int = 0               # transient engine-call failures
    #                                replayed from the slot's carried
    #                                state (fault-injection recovery)
    quota_held: int = 0            # admission deferrals: a free slot
    #                                existed but the request's tenant was
    #                                at its concurrency quota (counted per
    #                                sweep the request sat out)
    chunks: int = 0                # scheduler chunks executed
    queue_wait_s: float = 0.0      # summed arrival -> admission wait
    queue_wait_max_s: float = 0.0
    first_outputs: int = 0         # requests whose first prediction landed
    ttfp_s: float = 0.0            # summed arrival -> first prediction
    ttfp_max_s: float = 0.0
    slot_steps_live: int = 0       # chunk steps that consumed real input
    slot_steps_total: int = 0      # chunk steps across the whole pool
    # arrival -> completion latencies (seconds), one per completed request
    # that reported one — the tail-latency record the p99 gates read
    latencies: list = dataclasses.field(default_factory=list, repr=False)
    # per-shard / per-tenant breakdown attached by merge(); None on a
    # plain instance
    shards: dict | None = dataclasses.field(default=None, repr=False)
    _EWMA_ALPHA = 0.2

    # additive counters merge() sums across shards; the *_max_s fields are
    # maxed and latency_ewma_s is calls-weighted instead.
    _SUM_FIELDS = ("calls", "deferred_calls", "sequences", "steps_real",
                   "steps_padded",
                   "seconds", "enqueued", "admitted", "completed",
                   "timed_out", "rejected", "shed", "retries",
                   "quota_held", "chunks", "queue_wait_s",
                   "first_outputs",
                   "ttfp_s", "slot_steps_live", "slot_steps_total")

    @staticmethod
    def merge(parts: "Sequence[ServeStats]",
              labels: Sequence[str] | None = None) -> "ServeStats":
        """Aggregate per-shard stats into one view.

        Additive counters are summed (``seconds`` becomes aggregate
        device-seconds — shards run concurrently, so throughput across a
        wall-clock window should be computed from the window, not from the
        merged ``seconds``), the ``*_max_s`` fields take the worst shard,
        and the latency EWMA is the calls-weighted mean.  The parts land on
        ``merged.shards`` keyed by ``labels`` (default ``shard0..N``) and
        show up as a per-shard breakdown in ``summary()``/``render()``.
        """
        parts = list(parts)
        if labels is None:
            labels = [f"shard{i}" for i in range(len(parts))]
        merged = ServeStats()
        for f in ServeStats._SUM_FIELDS:
            setattr(merged, f, sum(getattr(p, f) for p in parts))
        merged.queue_wait_max_s = max(
            (p.queue_wait_max_s for p in parts), default=0.0)
        merged.ttfp_max_s = max((p.ttfp_max_s for p in parts), default=0.0)
        if merged.calls:
            merged.latency_ewma_s = sum(
                p.latency_ewma_s * p.calls for p in parts) / merged.calls
        for p in parts:
            merged.latencies.extend(p.latencies)
        merged.shards = dict(zip(labels, parts))
        return merged

    def record_call(self, *, batch: int, steps: int, seconds: float,
                    real_steps: int | None = None,
                    deferred: bool = False) -> None:
        """Account one rollout call of ``batch`` sequences x ``steps``.

        ``deferred=True`` marks a call whose ``seconds`` covers dispatch
        only (no host sync) — tracked so readers know when the timing
        columns are dispatch-side."""
        padded = batch * steps
        self.calls += 1
        self.deferred_calls += deferred
        self.sequences += batch
        self.steps_padded += padded
        self.steps_real += padded if real_steps is None else real_steps
        self.seconds += seconds
        if self.calls == 1:
            self.latency_ewma_s = seconds
        else:
            a = self._EWMA_ALPHA
            self.latency_ewma_s = a * seconds + (1 - a) * self.latency_ewma_s

    # -- continuous-batching accounting --------------------------------------
    def record_enqueue(self) -> None:
        self.enqueued += 1

    def record_admission(self, wait_s: float) -> None:
        """One request seated; ``wait_s`` is its arrival -> admit wait."""
        self.admitted += 1
        self.queue_wait_s += wait_s
        self.queue_wait_max_s = max(self.queue_wait_max_s, wait_s)

    def record_first_output(self, ttfp_s: float) -> None:
        """First chunk of output ready, ``ttfp_s`` after the arrival."""
        self.first_outputs += 1
        self.ttfp_s += ttfp_s
        self.ttfp_max_s = max(self.ttfp_max_s, ttfp_s)

    def record_completion(self, latency_s: float | None = None) -> None:
        """One request fully served; ``latency_s`` (arrival -> finish on
        the server's clock) feeds the tail-latency percentiles."""
        self.completed += 1
        if latency_s is not None:
            self.latencies.append(float(latency_s))

    def record_timeout(self) -> None:
        """One queued request dropped because its deadline passed before a
        slot freed up (it never occupied one)."""
        self.timed_out += 1

    def record_rejection(self, *, shed: bool = False) -> None:
        """One submission refused at the door by the admission policy.

        ``shed=True`` marks a deadline shed (the delay estimate said the
        deadline cannot be met); otherwise it is a hard rejection
        (bounded queue depth / tenant fairness).  Rejected requests never
        enter the queue, so they appear in neither ``enqueued`` nor
        ``timed_out``."""
        if shed:
            self.shed += 1
        else:
            self.rejected += 1

    def record_retry(self) -> None:
        """One transient engine-call failure replayed (bit-identically)
        from the slot's last carried state."""
        self.retries += 1

    def record_quota_hold(self) -> None:
        """One admission sweep skipped a request whose tenant was at its
        concurrency quota (the request stays queued, other tenants seat
        past it — quota never head-of-line blocks the FIFO)."""
        self.quota_held += 1

    def record_chunk(self, *, live_steps: int, total_steps: int) -> None:
        """One scheduler chunk: ``live_steps`` of the pool's
        ``total_steps`` executed steps consumed real request input (a
        retiring sequence's zero-padded tail does not count)."""
        self.chunks += 1
        self.slot_steps_live += live_steps
        self.slot_steps_total += total_steps

    @property
    def steps_per_sec(self) -> float:
        """Raw executed-step throughput (includes padding work)."""
        return self.steps_padded / self.seconds if self.seconds > 0 else 0.0

    @property
    def goodput_steps_per_sec(self) -> float:
        """Useful-step throughput (padding excluded)."""
        return self.steps_real / self.seconds if self.seconds > 0 else 0.0

    @property
    def padding_efficiency(self) -> float:
        """Fraction of executed steps that served real requests."""
        if self.steps_padded == 0:
            return 1.0
        return self.steps_real / self.steps_padded

    @property
    def mean_queue_wait_s(self) -> float:
        """Mean arrival -> admission wait across admitted requests."""
        return self.queue_wait_s / self.admitted if self.admitted else 0.0

    @property
    def mean_ttfp_s(self) -> float:
        """Mean arrival -> first-prediction latency, over the requests
        that actually produced output — admitted-but-still-silent requests
        (and the zero-completions case, e.g. every request timed out in
        the queue) don't skew or crash the mean."""
        return self.ttfp_s / self.first_outputs if self.first_outputs else 0.0

    def latency_percentile(self, p: float) -> float:
        """The ``p``-th percentile (0..100, nearest-rank) of recorded
        arrival -> completion latencies; 0.0 when none were recorded."""
        if not self.latencies:
            return 0.0
        ordered = sorted(self.latencies)
        rank = max(0, min(len(ordered) - 1,
                          int(round(p / 100.0 * len(ordered))) - 1))
        return ordered[rank]

    @property
    def p99_latency_s(self) -> float:
        return self.latency_percentile(99.0)

    @property
    def slot_occupancy(self) -> float:
        """Fraction of pool chunk-steps that consumed real request input."""
        if self.slot_steps_total == 0:
            return 1.0
        return self.slot_steps_live / self.slot_steps_total

    def summary(self) -> dict:
        out = {
            "calls": self.calls,
            "sequences": self.sequences,
            "steps_real": self.steps_real,
            "steps_padded": self.steps_padded,
            "seconds": self.seconds,
            "steps_per_sec": self.steps_per_sec,
            "goodput_steps_per_sec": self.goodput_steps_per_sec,
            "padding_efficiency": self.padding_efficiency,
            "latency_ewma_ms": self.latency_ewma_s * 1e3,
        }
        if self.deferred_calls:
            # timing columns are dispatch-side for these calls; makespan
            # clocks (AsyncReservoirServer.now) carry the honest number
            out["deferred_calls"] = self.deferred_calls
        if self.enqueued:
            out.update({
                "enqueued": self.enqueued,
                "admitted": self.admitted,
                "completed": self.completed,
                "timed_out": self.timed_out,
                "chunks": self.chunks,
                "mean_queue_wait_ms": self.mean_queue_wait_s * 1e3,
                "max_queue_wait_ms": self.queue_wait_max_s * 1e3,
                "mean_ttfp_ms": self.mean_ttfp_s * 1e3,
                "max_ttfp_ms": self.ttfp_max_s * 1e3,
                "slot_occupancy": self.slot_occupancy,
            })
            if self.quota_held:
                out["quota_held"] = self.quota_held
            if self.rejected or self.shed:
                out["rejected"] = self.rejected
                out["shed"] = self.shed
            if self.retries:
                out["retries"] = self.retries
            if self.latencies:
                out["p50_latency_ms"] = self.latency_percentile(50.0) * 1e3
                out["p99_latency_ms"] = self.p99_latency_s * 1e3
        if self.shards is not None:
            out["shards"] = {label: part.summary()
                             for label, part in self.shards.items()}
        return out

    def render(self) -> str:
        s = self.summary()
        line = (f"{s['calls']} calls, {s['sequences']} seqs, "
                f"{s['steps_real']} steps "
                f"({s['padding_efficiency']:.0%} of executed work useful), "
                f"{s['steps_per_sec']:.0f} steps/s raw, "
                f"{s['goodput_steps_per_sec']:.0f} steps/s goodput, "
                f"p-call latency {s['latency_ewma_ms']:.2f} ms (ewma)")
        if self.enqueued:
            line += (f"; queue: {s['completed']}/{s['enqueued']} done in "
                     f"{s['chunks']} chunks, "
                     f"wait {s['mean_queue_wait_ms']:.2f} ms mean / "
                     f"{s['max_queue_wait_ms']:.2f} ms max, "
                     f"ttfp {s['mean_ttfp_ms']:.2f} ms mean, "
                     f"occupancy {s['slot_occupancy']:.0%}")
            # drops and holds are SLO facts: always rendered (zero
            # included), so a dashboard line never hides them
            line += f", {self.timed_out} timed out"
            line += f", {self.rejected} rejected"
            line += f", {self.shed} shed"
            line += f", {self.quota_held} quota held"
        if self.shards is not None:
            for label, p in self.shards.items():
                line += (f"\n  {label}: {p.admitted} admitted, "
                         f"{p.completed} done, "
                         f"{p.slot_steps_live} live steps, "
                         f"occupancy {p.slot_occupancy:.0%}")
        return line
