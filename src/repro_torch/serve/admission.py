"""Backpressure and admission control for the serving queue.

The paper's pitch is *bounded* latency — a spatially compiled multiplier
whose per-step cost is static and predictable.  An unbounded FIFO throws
that away at the front door: under overload the queue (and therefore
queue-wait) grows without limit while the engine itself keeps its
promise.  This module closes the gap with a pluggable
:class:`AdmissionPolicy` consulted by the server at ``submit()`` time:

* :class:`BoundedQueuePolicy` — reject when the queue is already
  ``max_depth`` deep (classic backpressure);
* :class:`DeadlineShedPolicy` — shed a request whose deadline the
  *estimated* queue delay already blows, so it never burns a slot (or a
  queue position) on an answer nobody will wait for;
* :class:`TenantFairnessPolicy` — weighted per-tenant share of the
  in-system work, on top of the registry's concurrency quota (quota
  bounds *seated* slots; fairness bounds a tenant's claim on the whole
  queue under contention);
* :class:`CompositePolicy` — chain; first rejection wins.

A refused submission never enters the queue: the server answers
immediately with ``RolloutResult(status="rejected")`` carrying the
rejection ``reason`` and a ``retry_after_s`` hint in ``timings``, and
counts it in ``ServeStats.rejected`` / ``.shed`` and the
``requests_rejected_total`` / ``requests_shed_total`` obs metrics.

The per-chunk cost estimate (:func:`estimate_chunk_seconds`) prefers the
server's fixed ``chunk_time``, then the measured EWMA of its chunks, then
the plan autotuner's calibrated cost model for the pool shape, so
admission is cost-aware from the very first submit.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Rejection:
    """An admission policy's verdict on one submission.

    ``reason`` names the rule that fired (``"queue_full"`` /
    ``"deadline_unmeetable"`` / ``"tenant_over_share"``);
    ``retry_after_s`` is the policy's estimate of how long until a
    resubmission could succeed; ``shed=True`` marks a deadline shed
    (counted separately from hard rejections — shedding is the policy
    *keeping* the latency promise, not refusing service).
    """

    reason: str
    retry_after_s: float
    shed: bool = False


class AdmissionPolicy:
    """Decide, at submit time, whether a request may join the queue.

    ``admit(server, qreq)`` answers ``None`` to accept or a
    :class:`Rejection` to refuse.  The policy sees the live server
    (queue depth, pool occupancy, stats, registry) and the fully-built
    :class:`~repro_torch.serve.scheduler.QueuedRequest`, so custom policies
    can weigh anything those expose.  The base class accepts everything.
    """

    def admit(self, server, qreq) -> Rejection | None:
        return None


def estimate_chunk_seconds(server) -> float:
    """Best available per-chunk cost estimate for ``server``'s pool.

    Preference order: the fixed virtual-clock ``chunk_time`` when set
    (it *is* the chunk cost by definition), the measured per-call EWMA
    once chunks have run, then the calibrated cost model's analytic
    prediction for the pool shape (``n_slots`` x ``chunk_steps`` under
    the engine's resolved schedule, priced for the engine's device) — so
    admission decisions are cost-aware from the very first submit, before
    anything has been measured.
    """
    if server.chunk_time is not None:
        return float(server.chunk_time)
    st = server.stats
    if st.chunks and st.latency_ewma_s > 0:
        return float(st.latency_ewma_s)
    eng = server.batcher.engine
    try:
        from repro_torch.plan.autotune import Schedule, predict_cost
        sched = eng.schedule
        if sched is None:
            sched = Schedule(
                "int8" if eng.config.mode.startswith("int8") else "fp32",
                eng.backend, eng.vmem_budget, eng.crossover,
                eng.batch_tile_max)
        est = predict_cost(eng.plan, sched, server.batcher.n_slots,
                           server.batcher.chunk_steps, device=eng.device)
        return max(float(est), 1e-6)
    except (KeyError, TypeError, ValueError):
        # the cost model cannot price this engine (no coefficients for
        # its backend, no batch tile, an infeasible budget): fall back to
        # a small constant so policies stay functional
        return 1e-3


def estimate_queue_delay(server) -> float:
    """Estimated wait before a request submitted *now* would seat.

    Work-conserving estimate: every step still owed to seated slots plus
    every queued request's full length must drain through the pool at
    ``n_slots * chunk_steps`` steps per chunk before a new arrival is
    guaranteed a seat; each chunk costs :func:`estimate_chunk_seconds`.
    This is an upper-ish bound under FIFO (a request may seat earlier
    when a short slot retires), which is the right bias for shedding:
    never promise a deadline the queue cannot keep.
    """
    b = server.batcher
    live_steps = sum(q.length - b._pos[i]
                     for i, q in enumerate(b._slots) if q is not None)
    queued_steps = sum(entry[2].length for entry in server._queue)
    backlog = live_steps + queued_steps
    if backlog <= 0:
        return 0.0
    per_chunk_steps = b.n_slots * b.chunk_steps
    chunks = math.ceil(backlog / per_chunk_steps)
    return chunks * estimate_chunk_seconds(server)


@dataclasses.dataclass
class BoundedQueuePolicy(AdmissionPolicy):
    """Reject when the queue already holds ``max_depth`` requests.

    The retry hint is the time for one queue position to drain
    (total estimated delay spread over the queued requests), floored at
    one chunk.
    """

    max_depth: int = 64

    def admit(self, server, qreq) -> Rejection | None:
        depth = server.pending
        if depth < self.max_depth:
            return None
        retry = max(estimate_chunk_seconds(server),
                    estimate_queue_delay(server) / max(1, depth))
        return Rejection("queue_full", retry_after_s=retry)


@dataclasses.dataclass
class DeadlineShedPolicy(AdmissionPolicy):
    """Shed a request whose deadline the queue-delay estimate already
    blows — it would only be dropped (``timed_out``) later anyway, after
    holding a queue position the whole time.

    ``slack`` scales the estimate (>1.0 sheds more conservatively).
    Requests without a deadline always pass.
    """

    slack: float = 1.0

    def admit(self, server, qreq) -> Rejection | None:
        if qreq.deadline is None:
            return None
        est = estimate_queue_delay(server) * self.slack
        budget = qreq.deadline - qreq.arrival_time
        if est <= budget:
            return None
        return Rejection("deadline_unmeetable",
                         retry_after_s=max(0.0, est - budget), shed=True)


@dataclasses.dataclass
class TenantFairnessPolicy(AdmissionPolicy):
    """Weighted fair share of the *in-system* work per tenant.

    Under contention (seated + queued >= pool size) a tenant may hold at
    most ``ceil(w_i / W * in_system)`` of the in-system requests, where
    ``W`` sums the weights of the tenants currently present (plus the
    candidate's).  With equal weights this is plain proportional
    fairness; weights tilt the split.  Below contention the policy never
    fires — fairness is about dividing scarcity, not idle capacity.
    Complements the registry quota, which bounds only *seated* slots.
    """

    weights: dict = dataclasses.field(default_factory=dict)
    default_weight: float = 1.0

    def _weight(self, model) -> float:
        return float(self.weights.get(model, self.default_weight))

    def admit(self, server, qreq) -> Rejection | None:
        b = server.batcher
        counts: dict = {}
        for q in b._slots:
            if q is not None:
                counts[q.model] = counts.get(q.model, 0) + 1
        for entry in server._queue:
            m = entry[2].model
            counts[m] = counts.get(m, 0) + 1
        in_system = sum(counts.values()) + 1          # incl. the candidate
        if in_system <= b.n_slots:
            return None
        tenants = set(counts) | {qreq.model}
        total_w = sum(self._weight(m) for m in tenants)
        share = self._weight(qreq.model) / total_w if total_w > 0 else 0.0
        cap = max(1, math.ceil(share * in_system))
        mine = counts.get(qreq.model, 0) + 1
        if mine <= cap:
            return None
        return Rejection("tenant_over_share",
                         retry_after_s=estimate_chunk_seconds(server))


class CompositePolicy(AdmissionPolicy):
    """Chain policies; the first rejection wins, acceptance needs all."""

    def __init__(self, *policies: AdmissionPolicy):
        self.policies = list(policies)

    def admit(self, server, qreq) -> Rejection | None:
        for p in self.policies:
            verdict = p.admit(server, qreq)
            if verdict is not None:
                return verdict
        return None


def default_policy(*, max_depth: int = 64,
                   weights: dict | None = None) -> CompositePolicy:
    """The production default: bounded queue, deadline shedding, and
    (when ``weights`` given, or unconditionally with equal weights)
    tenant fairness — in that order."""
    return CompositePolicy(
        BoundedQueuePolicy(max_depth=max_depth),
        DeadlineShedPolicy(),
        TenantFairnessPolicy(weights=weights or {}))


__all__ = ["Rejection", "AdmissionPolicy", "BoundedQueuePolicy",
           "DeadlineShedPolicy", "TenantFairnessPolicy", "CompositePolicy",
           "default_policy", "estimate_chunk_seconds",
           "estimate_queue_delay"]
