"""Elastic re-planning, autoscaling and liveness (fault-tolerance runtime).

On a real cluster the runtime detects failed hosts (missed heartbeats),
shrinks the device pool to the survivors, recomputes what each device
holds, and resumes.  All the policy logic is here and unit-tested; the
detection transport (heartbeats) is a thin interface a deployment fills
in.  The serving side (:func:`shrink_serve_plan`, :func:`grow_serve_plan`,
:class:`AutoscalePolicy`) is what
:class:`~repro_torch.dist.DistributedReservoirServer` executes, and
:func:`swap_serve_plan` is the contract
:meth:`~repro_torch.serve.registry.ModelRegistry.publish` executes.
Framework-free: the returned plans equal the JAX package's exactly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

__all__ = ["plan_mesh", "replan_after_failure", "shrink_serve_plan",
           "grow_serve_plan", "swap_serve_plan", "AutoscalePolicy",
           "StragglerWatchdog", "Heartbeats"]


def plan_mesh(n_devices: int, model_parallel: int,
              pods: int = 1) -> tuple[tuple, tuple]:
    """Choose (shape, axis_names) for a device count.

    Keeps model-parallel width fixed (weights must still fit) and gives the
    rest to data parallelism; degrades MP only when unavoidable.
    """
    mp = model_parallel
    while mp > 1 and (n_devices % (mp * pods)) != 0:
        mp //= 2
    dp = n_devices // (mp * pods)
    if pods > 1:
        return (pods, dp, mp), ("pod", "data", "model")
    return (dp, mp), ("data", "model")


def replan_after_failure(prev_devices: int, failed: int, model_parallel: int,
                         pods: int = 1) -> dict:
    """Failure response plan: new device layout + what must happen to state.

    Returns a dict describing the recovery actions in order, for the
    caller to execute.
    """
    survivors = prev_devices - failed
    # shrink to the largest usable device count (keep the layout factorable)
    usable = survivors
    mp = model_parallel
    while usable > 0 and usable % (mp * pods) != 0:
        usable -= 1
    shape, axes = plan_mesh(max(usable, mp * pods), model_parallel, pods)
    return {
        "survivors": survivors,
        "usable_devices": max(usable, mp * pods),
        "mesh_shape": shape,
        "mesh_axes": axes,
        "actions": [
            "barrier: drain in-flight steps",
            "restore latest verified checkpoint (checkpoint.store.restore "
            "with new shardings)",
            f"rescale global batch or keep per-device batch "
            f"(dp {prev_devices // model_parallel} -> "
            f"{max(usable, mp * pods) // (model_parallel * pods)})",
            "resume from restored step counter (data stream is stateless)",
        ],
    }


def shrink_serve_plan(n_shards: int, failed: int) -> dict:
    """Failure response for a data-parallel *serving* pool.

    Serving shards carry no model parallelism (the reservoir is replicated),
    so every survivor count is usable — ``replan_after_failure`` with
    ``model_parallel=1`` gives the new width — but the state that must
    survive is different from training: there is no checkpoint to restore,
    the in-flight reservoir states ARE the recovery payload.  The action
    list reflects that; ``DistributedReservoirServer.shrink`` executes it.
    """
    base = replan_after_failure(n_shards, failed, model_parallel=1)
    base["actions"] = [
        "freeze admission; no new chunk is launched",
        "snapshot per-slot reservoir state x(t) and consumed step counts",
        "rebuild the sharded engine on the surviving mesh (ExecutionPlan "
        "is cached per matrix — no re-lowering)",
        "re-admit in-flight sequences with x0 = snapshot via the global "
        "FIFO (least-loaded shard admission)",
        "resume: queued requests were never lost, they stay in the FIFO",
    ]
    return base


def grow_serve_plan(n_shards: int, added: int,
                    max_shards: int | None = None) -> dict:
    """Scale-up response for a data-parallel serving pool — the inverse
    of :func:`shrink_serve_plan`.

    New shards join under live traffic: the engine is rebuilt on the
    wider device list (the :class:`ExecutionPlan` is cached per matrix, so
    this is replica set-up only, and each shard's launch is unchanged —
    the local sub-pool shape ``(slots_per_shard, chunk_steps, I)`` does
    not depend on the shard count, which is what keeps resumed
    trajectories bit-identical across the rebuild), and the in-flight
    snapshot re-admits through the global FIFO whose least-loaded
    admission rebalances the sub-pools over the wider pool automatically.
    Completed work is never dropped or re-run: produced chunks are
    stitched as prefixes, states resume from the snapshot carry.
    ``DistributedReservoirServer.grow`` executes the plan.
    """
    if added < 0:
        raise ValueError(f"added must be >= 0, got {added}")
    new_n = n_shards + added
    if max_shards is not None:
        new_n = min(new_n, max_shards)
    shape, axes = plan_mesh(max(new_n, 1), model_parallel=1)
    return {
        "n_shards_before": n_shards,
        "n_shards_after": new_n,
        "added": new_n - n_shards,
        "mesh_shape": shape,
        "mesh_axes": axes,
        "actions": [
            "freeze admission; no new chunk is launched",
            "snapshot per-slot reservoir state x(t), consumed step "
            "counts, and produced chunks",
            "rebuild the sharded engine on the widened mesh "
            "(ExecutionPlan is cached per matrix — no re-lowering; the "
            "per-shard program shape is unchanged)",
            "re-admit in-flight sequences with x0 = snapshot via the "
            "global FIFO — least-loaded shard admission rebalances the "
            "sub-pools across the new width",
            "resume: queued requests were never lost, they stay in the "
            "FIFO and now drain over more shards",
        ],
    }


@dataclasses.dataclass
class AutoscalePolicy:
    """Queue-depth / occupancy driven elastic scaling decisions.

    Consulted by ``DistributedReservoirServer`` once per scheduler step:
    ``decide()`` answers +1 (grow a shard), -1 (retire a shard) or 0.
    Growth triggers when the backlog exceeds ``grow_queue_per_slot``
    queued requests per pool slot — the queue is outrunning the pool;
    scale-down triggers only when the queue is EMPTY and pool occupancy
    sits below ``shrink_occupancy`` — capacity is provably idle.
    ``cooldown_steps`` scheduler steps must pass between decisions so a
    rebuild's re-admission transient never triggers the next decision
    (flap damping).
    """

    min_shards: int = 1
    max_shards: int = 8
    grow_queue_per_slot: float = 1.0
    shrink_occupancy: float = 0.25
    cooldown_steps: int = 4

    def decide(self, *, pending: int, live: int, n_slots: int,
               n_shards: int) -> int:
        if (n_shards < self.max_shards
                and pending > self.grow_queue_per_slot * n_slots):
            return 1
        if (n_shards > self.min_shards and pending == 0
                and live <= self.shrink_occupancy * n_slots):
            return -1
        return 0


def swap_serve_plan(name: str, old_version: int | None,
                    new_version: int) -> dict:
    """Live-swap response for a multi-tenant serving pool.

    Publishing a new version of a served model changes nothing about the
    devices, but the engine behind a tenant's admissions does, and the
    state that must survive is the in-flight work.  The action list is the
    contract ``ModelRegistry.publish`` executes — build *before* cutover,
    pin in-flight slots to the engine they started on, and make the
    cutover a single atomic active-version write so no request ever
    observes a half-swapped model.
    """
    return {
        "model": name,
        "previous_version": old_version,
        "version": new_version,
        "actions": [
            "build the new version's engine off-path (plan -> specialize "
            "-> kernel tables; ExecutionPlan cached per registry identity)",
            "prewarm it against every attached server's pool shapes "
            "(chunk launch run before any request routes to it)",
            "atomic cutover: flip the registry's active version — new "
            "admissions pin the new engine",
            "in-flight slots keep their admission-pinned engine and run "
            "to completion (zero drops, bit-exact both sides)",
            "demote the retired version in the engine LRU so it is first "
            "out once its last pinned slot retires",
        ],
    }


@dataclasses.dataclass
class Heartbeats:
    """Liveness tracking: hosts report; stale hosts are failures."""

    timeout_s: float = 30.0
    _last: dict = dataclasses.field(default_factory=dict)

    def beat(self, host: str, now: Optional[float] = None):
        self._last[host] = now if now is not None else time.monotonic()

    def failed(self, now: Optional[float] = None) -> list:
        now = now if now is not None else time.monotonic()
        return sorted(h for h, t in self._last.items()
                      if now - t > self.timeout_s)


class StragglerWatchdog:
    """Flags steps whose duration exceeds median * threshold.

    At cluster scale the mitigation hook triggers (a) collective timeout
    tuning, (b) hot-spare promotion; here the policy and detection are
    real and tested, the mitigation is a callback.
    """

    def __init__(self, window: int = 50, threshold: float = 3.0,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.window = window
        self.threshold = threshold
        self.on_straggler = on_straggler
        self.durations: list = []
        self.flagged: list = []

    def record(self, step: int, duration_s: float):
        hist = self.durations[-self.window:]
        if len(hist) >= 5:
            med = float(np.median(hist))
            if duration_s > self.threshold * med:
                self.flagged.append((step, duration_s))
                if self.on_straggler:
                    self.on_straggler(step, duration_s)
        self.durations.append(duration_s)

    @property
    def median(self) -> float:
        return float(np.median(self.durations)) if self.durations else 0.0
