"""Deterministic fault injection for the serving stack.

A :class:`FaultPlan` is a seeded, pre-materialized schedule of failures
on the server's virtual clock — shard deaths, slow-shard (straggler)
chunks, transient engine-call failures, and publish-mid-swap aborts.
Determinism is the point: the sustained-load harness replays the same
trace with and without the plan and asserts every completed request is
bit-identical, and a CI failure under chaos reproduces exactly.

Injection sites (all consult the plan, none depend on wall time):

* ``AsyncReservoirServer.step()`` calls :meth:`FaultPlan.begin_chunk`
  with the server clock, activating any events whose time has come;
* ``ContinuousBatcher.run_chunk()`` calls :meth:`FaultPlan.check_call`
  before each fused engine call — an armed transient fault raises
  :class:`TransientFault` and the batcher retries with capped
  exponential backoff from the slot's last carried state (the inputs
  and the pre-chunk state are untouched, so the replay is bit-identical
  by construction);
* ``DistributedReservoirServer.step()`` drains
  :meth:`FaultPlan.take_dead_shards` and converts them into the
  existing elastic ``shrink()`` path — unplanned shard death becomes a
  planned rebuild with zero request loss;
* straggler windows inflate the chunk's charge on the virtual clock via
  :meth:`FaultPlan.slow_factor` (under ``shard_map`` one straggling
  shard stalls the whole synchronized chunk, so a single pool-wide
  factor is the honest model);
* ``ModelRegistry.publish()`` consults the installed plan via
  :func:`active` and aborts *after* prewarm but *before* the atomic
  cutover when :meth:`FaultPlan.take_publish_abort` fires — the worst
  moment — leaving the old version serving untouched.
"""

from __future__ import annotations

import dataclasses

from repro_torch import obs


class TransientFault(RuntimeError):
    """An injected transient engine-call failure (retryable)."""


class PublishAborted(RuntimeError):
    """An injected abort between prewarm and cutover of a live swap.

    The registry guarantees the active version is unchanged when this
    propagates; the prewarmed version stays registered (inactive) so a
    retry can activate it without recompiling.
    """


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``kind`` is ``"shard_loss"`` / ``"slow_shard"`` / ``"transient"`` /
    ``"publish_abort"``; ``at`` is the activation time on the server's
    clock.  ``shard`` names the victim for shard faults, ``duration`` /
    ``factor`` shape a straggler window, ``count`` is how many
    consecutive engine calls a transient event fails.
    """

    kind: str
    at: float
    shard: int | None = None
    duration: float = 0.0
    factor: float = 1.0
    count: int = 1


class FaultPlan:
    """A deterministic schedule of :class:`FaultEvent`\\ s plus the
    retry/backoff parameters recovery uses.

    Build one explicitly from events, or :meth:`seeded` for a
    reproducible random schedule over a trace horizon.  The plan is
    consumed as the server clock passes each event's ``at``; ``injected``
    counts what actually fired, keyed by kind.
    """

    def __init__(self, events: list[FaultEvent] | None = None, *,
                 backoff_base_s: float = 0.001, backoff_cap_s: float = 0.05,
                 max_attempts: int = 64):
        self.events = sorted(events or [], key=lambda e: e.at)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.max_attempts = int(max_attempts)
        self.injected: dict[str, int] = {}
        self.now = 0.0
        self._cursor = 0               # next not-yet-activated event
        self._pending_transient = 0    # armed engine-call failures
        self._slow_until = 0.0
        self._slow_factor = 1.0
        self._dead: list[int] = []     # activated, not yet taken
        self._publish_aborts = 0
        self.fault_times: dict[str, list[float]] = {}

    @classmethod
    def seeded(cls, seed: int, *, horizon: float, n_shards: int = 0,
               transient_rate: float = 0.0, slow_rate: float = 0.0,
               shard_loss_times: list[float] | None = None,
               slow_factor: float = 4.0, slow_duration: float = 2.0,
               **kw) -> "FaultPlan":
        """A reproducible random schedule: Poisson-ish transient and
        straggler events over ``[0, horizon)`` from ``seed``, plus
        explicit shard losses (chaos traces pin those so recovery time
        is measured against a known instant)."""
        import numpy as np
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        for rate, kind in ((transient_rate, "transient"),
                           (slow_rate, "slow_shard")):
            if rate <= 0:
                continue
            t = 0.0
            while True:
                t += float(rng.exponential(1.0 / rate))
                if t >= horizon:
                    break
                if kind == "transient":
                    events.append(FaultEvent("transient", at=t,
                                             count=1 + int(rng.integers(2))))
                else:
                    shard = (int(rng.integers(n_shards)) if n_shards
                             else None)
                    events.append(FaultEvent(
                        "slow_shard", at=t, shard=shard,
                        factor=slow_factor, duration=slow_duration))
        for t in (shard_loss_times or []):
            events.append(FaultEvent("shard_loss", at=float(t), shard=0))
        return cls(events, **kw)

    # -- activation ----------------------------------------------------------
    def begin_chunk(self, now: float) -> None:
        """Advance the plan to the server clock: activate every event
        whose time has come.  Called once per scheduler step."""
        self.now = float(now)
        while (self._cursor < len(self.events)
               and self.events[self._cursor].at <= self.now):
            ev = self.events[self._cursor]
            self._cursor += 1
            self._record(ev.kind)
            if ev.kind == "transient":
                self._pending_transient += ev.count
            elif ev.kind == "slow_shard":
                self._slow_until = max(self._slow_until,
                                       self.now + ev.duration)
                self._slow_factor = max(self._slow_factor, ev.factor)
            elif ev.kind == "shard_loss":
                self._dead.append(0 if ev.shard is None else ev.shard)
            elif ev.kind == "publish_abort":
                self._publish_aborts += ev.count

    def _record(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1
        self.fault_times.setdefault(kind, []).append(self.now)
        obs.inc("faults_injected_total", kind=kind)

    # -- consumption ---------------------------------------------------------
    def check_call(self) -> None:
        """Raise :class:`TransientFault` while transient failures are
        armed (each raise consumes one).  The batcher's retry loop calls
        this before every fused engine launch."""
        if self._pending_transient > 0:
            self._pending_transient -= 1
            raise TransientFault(
                f"injected transient engine-call failure at t={self.now:.3f}")

    def backoff_s(self, attempt: int) -> float:
        """Capped exponential backoff delay for retry ``attempt``
        (0-based)."""
        return min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** attempt))

    def slow_factor(self) -> float:
        """Multiplier on the current chunk's virtual-clock charge — 1.0
        outside straggler windows."""
        if self.now < self._slow_until:
            return self._slow_factor
        self._slow_factor = 1.0
        return 1.0

    def take_dead_shards(self) -> list[int]:
        """Drain shard deaths activated since the last call.  The
        distributed server converts each batch into one ``shrink()``."""
        dead, self._dead = self._dead, []
        return dead

    def arm_publish_abort(self, count: int = 1) -> None:
        """Arm the next ``count`` publishes to abort mid-swap (clock-free
        arming for tests; scheduled ``publish_abort`` events arm the same
        counter)."""
        self._publish_aborts += count
        self._record("publish_abort")

    def take_publish_abort(self) -> bool:
        """Consume one armed publish abort, if any."""
        if self._publish_aborts > 0:
            self._publish_aborts -= 1
            return True
        return False


# -- module-global plan (for sites with no server handle) --------------------
_ACTIVE: FaultPlan | None = None


def install(plan: FaultPlan | None) -> None:
    """Install ``plan`` as the process-global fault plan consulted by
    sites that have no server handle (``ModelRegistry.publish``).
    Servers take their plan explicitly (``fault_plan=``); ``install``
    exists so one plan can cover both.  ``install(None)`` clears."""
    global _ACTIVE
    _ACTIVE = plan


def active() -> FaultPlan | None:
    """The installed process-global plan, or None."""
    return _ACTIVE


__all__ = ["FaultPlan", "FaultEvent", "TransientFault", "PublishAborted",
           "install", "active"]
