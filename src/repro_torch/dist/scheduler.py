"""Shard-aware continuous batching + elastic shrink and grow.

One global FIFO feeds a slot pool that is partitioned across the mesh:
slot ``k`` lives on shard ``k // slots_per_shard``, and every chunk is
still ONE (sharded) engine call — each shard rolls its own sub-pool with
one launch, with no collective between shards.  Admission is
*least-loaded*: a request seats in the shard with the most free slots,
keeping the sub-pools balanced so no shard idles while another queues.

Elastic shrink (:meth:`DistributedReservoirServer.shrink`) is the serving
side of :mod:`repro_torch.runtime.elastic`: on a shard loss the mesh is
re-planned to the survivors, the engine is rebuilt from the cached
:class:`~repro_torch.plan.ExecutionPlan` (no re-lowering), and every
in-flight sequence is re-admitted through the global FIFO with its
snapshotted reservoir state as ``x0`` — the chunk API makes the resumed
trajectory bit-identical, so no request is lost and no step is
recomputed.  :meth:`~DistributedReservoirServer.grow` is the inverse.

The device ceiling is a pool of devices (``devices=``), not the JAX
package's ``len(jax.devices())``: the mesh is always a prefix of that
pool, and a device may repeat in it, so N shards can share one card.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch import obs
from repro_torch.dist.engine import ShardedReservoirEngine
from repro_torch.launch.mesh import local_devices, make_data_mesh
from repro_torch.runtime.elastic import grow_serve_plan, shrink_serve_plan
from repro_torch.serve.batching import RolloutRequest
from repro_torch.serve.scheduler import AsyncReservoirServer, ContinuousBatcher
from repro_torch.serve.stats import ServeStats

__all__ = ["ShardedContinuousBatcher", "DistributedReservoirServer"]


class ShardedContinuousBatcher(ContinuousBatcher):
    """Slot pool partitioned into per-shard sub-pools.

    ``n_slots = n_shards * slots_per_shard``; the chunk mechanics (state
    carry, retirement, mid-flight admission, per-model grouping) are
    inherited — the engine call is sharded under the hood, so each
    shard's sub-pool rolls on its own device.  Per-shard telemetry
    accumulates in ``shard_stats`` and aggregates through
    :meth:`ServeStats.merge`.
    """

    def __init__(self, engine: ShardedReservoirEngine, *,
                 slots_per_shard: int = 8, chunk_steps: int = 16,
                 want_states: bool | None = None,
                 zero_copy: bool | None = None, resolver=None):
        if slots_per_shard < 1:
            raise ValueError("slots_per_shard must be >= 1")
        self.n_shards = engine.n_shards
        self.slots_per_shard = slots_per_shard
        super().__init__(engine, n_slots=engine.n_shards * slots_per_shard,
                         chunk_steps=chunk_steps, want_states=want_states,
                         zero_copy=zero_copy, resolver=resolver)
        self.shard_stats = [ServeStats() for _ in range(self.n_shards)]

    def shard_of(self, slot: int) -> int:
        return slot // self.slots_per_shard

    def free_slots_by_shard(self) -> list:
        free = [0] * self.n_shards
        for i, q in enumerate(self._slots):
            if q is None:
                free[self.shard_of(i)] += 1
        return free

    def _free_slot(self) -> int:
        """Least-loaded admission: the emptiest shard's first free slot
        (lowest shard id on ties, so placement is deterministic)."""
        free = self.free_slots_by_shard()
        shard = max(range(self.n_shards), key=lambda s: (free[s], -s))
        lo = shard * self.slots_per_shard
        for i in range(lo, lo + self.slots_per_shard):
            if self._slots[i] is None:
                return i
        raise RuntimeError("no free slot")       # guarded by has_free_slot

    def _call_kwargs(self, slots: list) -> dict:
        return {"shards": sorted({self.shard_of(i) for i in slots})}

    def admit(self, qreq) -> int:
        slot = super().admit(qreq)
        wait = (0.0 if qreq.admit_time is None
                else qreq.admit_time - qreq.arrival_time)
        self.shard_stats[self.shard_of(slot)].record_admission(wait)
        return slot

    def run_chunk(self):
        retired, real = super().run_chunk()
        live = [0] * self.n_shards
        for slot, n in self.last_take.items():
            live[self.shard_of(slot)] += n
        for s in range(self.n_shards):
            self.shard_stats[s].record_chunk(
                live_steps=live[s],
                total_steps=self.slots_per_shard * self.chunk_steps)
        for slot in self.last_retired_slots:
            self.shard_stats[self.shard_of(slot)].record_completion()
        return retired, real

    def snapshot_live(self) -> list:
        """Freeze the in-flight work: ``(qreq, remaining_inputs, state,
        produced_chunks)`` per live slot — everything a rebuild needs to
        re-admit a sequence with nothing lost or recomputed.  States and
        the zero-copy input lanes are read from the device here, before
        the old replicas go away."""
        states = self._states.cpu().numpy()
        out = []
        for i, q in enumerate(self._slots):
            if q is None:
                continue
            out.append((q, self.remaining_inputs(i), states[i].copy(),
                        self.chunk_outputs(i)))
        return out


class DistributedReservoirServer(AsyncReservoirServer):
    """Global FIFO + sharded slot pool + elastic shrink and grow.

    The event loop is inherited from :class:`AsyncReservoirServer`
    (virtual clock, FIFO admission sweep, deadline drops); this class adds
    the sharded batcher, per-shard telemetry aggregation
    (:meth:`shard_summary`) and the elastic path (:meth:`shrink`,
    :meth:`grow`, shard deaths from a fault plan, an ``autoscale``
    :class:`~repro_torch.runtime.elastic.AutoscalePolicy`).

    ``devices`` is the pool the mesh may widen into, in order (a device
    may repeat); the engine's mesh must be a prefix of it.  By default it
    is the engine's mesh followed by the other ``local_devices()`` of the
    engine's device type.
    """

    def __init__(self, engine: ShardedReservoirEngine, *,
                 slots_per_shard: int = 8, chunk_steps: int = 16,
                 want_states: bool | None = None,
                 stats: ServeStats | None = None,
                 chunk_time: float | None = None,
                 zero_copy: bool | None = None,
                 registry=None, admission=None, fault_plan=None,
                 autoscale=None, devices=None):
        mesh = list(engine.mesh.devices)
        if devices is None:
            devices = mesh + [d for d in local_devices(engine.device)
                              if d not in mesh]
        self.devices = list(make_data_mesh(devices=devices).devices)
        if self.devices[:len(mesh)] != mesh:
            raise ValueError(f"the engine's mesh {mesh} is not a prefix of "
                             f"the device pool {self.devices}")
        self.engine = engine
        self.slots_per_shard = slots_per_shard
        self.chunk_steps = chunk_steps
        self.want_states = want_states
        batcher = ShardedContinuousBatcher(
            engine, slots_per_shard=slots_per_shard,
            chunk_steps=chunk_steps, want_states=want_states,
            zero_copy=zero_copy)
        super().__init__(engine, stats=stats, chunk_time=chunk_time,
                         batcher=batcher, registry=registry,
                         admission=admission, fault_plan=fault_plan)
        # elastic autoscaling: an AutoscalePolicy consulted once per step
        # (None = manual grow()/shrink() only)
        self.autoscale = autoscale
        self._autoscale_cooldown = 0
        self.reshards = 0                 # completed shrink operations
        self.grows = 0                    # completed grow operations
        self.readmitted = 0               # in-flight seqs carried across
        self._prefixes: dict = {}         # uid -> chunks produced pre-shrink
        self._shard_epochs: list = []     # pre-rebuild batchers' shard stats
        # mesh-mapped engines are per server (the mesh is part of their
        # identity), so tenant routing keeps its own (name, version) map
        # instead of the global engine_for LRU; a rebuild clears it
        self._model_engines: dict = {}

    @property
    def n_shards(self) -> int:
        return self.engine.n_shards

    def _tenant_engine(self, name: str, version: int):
        """Mesh-mapped engine for a pinned (model, version): built as a
        sibling of the primary engine (same mesh and dispatch policy, that
        model's params) and cached per server."""
        key = (name, version)
        eng = self._model_engines.get(key)
        if eng is None:
            mv = self.registry.get(name, version)
            eng = self.engine.like(mv.params, tenant=key)
            self._model_engines[key] = eng
        return eng

    def shard_summary(self) -> ServeStats:
        """All per-shard telemetry merged into one ``ServeStats`` (the
        parts stay addressable on ``.shards``).  Covers the whole run:
        after a rebuild the retired topology's stats stay in the merge,
        labelled ``epochN/shardK`` so totals (completions, admissions)
        never understate what the server actually served."""
        epochs = self._shard_epochs + [self.batcher.shard_stats]
        parts, labels = [], []
        for e, shard_list in enumerate(epochs):
            for i, s in enumerate(shard_list):
                parts.append(s)
                labels.append(f"shard{i}" if len(epochs) == 1
                              else f"epoch{e}/shard{i}")
        return ServeStats.merge(parts, labels)

    def step(self) -> bool:
        if self.autoscale is not None:
            self._maybe_autoscale()
        alive = super().step()
        # a sequence resumed across a rebuild retires with only its
        # post-rebuild output; prepend the snapshotted prefix chunks
        if self._prefixes:
            for uid in [u for u in self._prefixes if u in self.results]:
                prefix = self._prefixes.pop(uid)
                res = self.results[uid]
                full = np.concatenate(prefix + [np.asarray(res.output)],
                                      axis=0)
                self.results[uid] = dataclasses.replace(
                    res, preds=None if res.preds is None else full,
                    states=None if res.states is None else full)
        return alive

    # -- fault detection / autoscale -----------------------------------------
    def _handle_faults(self) -> None:
        """Convert activated shard deaths into the elastic shrink path.

        An unplanned shard death is *detected* here (the plan's clock
        passed the event) and handled with exactly the machinery a
        planned shrink uses: snapshot, rebuild on the survivors,
        re-admit — zero request loss, no new recovery code path."""
        dead = set(self.fault_plan.take_dead_shards())
        if not dead:
            return
        failed = min(len(dead), self.n_shards - 1)
        if failed <= 0:
            return
        obs.event("shard_death_detected", shards=sorted(dead),
                  at=self.now)
        self.shrink(failed=failed)

    def _maybe_autoscale(self) -> None:
        """One :class:`~repro_torch.runtime.elastic.AutoscalePolicy`
        consult, rate-limited by the policy's cooldown so a rebuild's
        re-admission transient cannot immediately trigger the next
        decision."""
        if self._autoscale_cooldown > 0:
            self._autoscale_cooldown -= 1
            return
        pol = self.autoscale
        verdict = pol.decide(pending=self.pending,
                             live=self.batcher.live,
                             n_slots=self.batcher.n_slots,
                             n_shards=self.n_shards)
        if verdict > 0:
            ceiling = min(pol.max_shards, len(self.devices))
            if self.n_shards < ceiling:
                self.grow(min(verdict, ceiling - self.n_shards))
                self._autoscale_cooldown = pol.cooldown_steps
        elif verdict < 0 and self.n_shards > pol.min_shards:
            self.shrink(
                failed=min(-verdict, self.n_shards - pol.min_shards))
            self._autoscale_cooldown = pol.cooldown_steps

    # -- elastic -------------------------------------------------------------
    def _rebuild(self, new_n: int) -> int:
        """Rebuild the pool on the first ``new_n`` devices of the pool,
        carrying every live slot across — the shared core of
        :meth:`shrink` and :meth:`grow`.

        Snapshots every live slot (state + remaining inputs + output so
        far) from the device, rebuilds the engine on the new mesh (the
        :class:`ExecutionPlan` is cached per matrix, so this is replica
        set-up only), stands up a fresh sharded batcher, and pushes the
        snapshots back through the global FIFO — they sort by their
        original arrival times, so they re-seat first (and on a grow the
        least-loaded admission spreads them over the new width).  Each
        shard's launch keeps its ``(slots_per_shard, chunk_steps)``
        shape, which keeps the resumed trajectories bit-identical.
        Returns the number of carried sequences.
        """
        carried = self.batcher.snapshot_live()
        engine = self.engine.like(
            mesh=make_data_mesh(devices=self.devices[:new_n]))
        self.engine = engine
        self._shard_epochs.append(self.batcher.shard_stats)
        self.batcher = ShardedContinuousBatcher(
            engine, slots_per_shard=self.slots_per_shard,
            chunk_steps=self.chunk_steps, want_states=self.want_states,
            zero_copy=self.batcher.zero_copy,
            resolver=self._resolve_engine)
        self.batcher.fault_plan = self.fault_plan
        # tenant engines were mapped on the old mesh — rebuilt lazily on
        # the new mesh as pinned requests re-resolve
        self._model_engines.clear()

        for qreq, remaining, state, chunks in carried:
            if chunks:
                self._prefixes[qreq.uid] = \
                    self._prefixes.pop(qreq.uid, []) + chunks
            qreq.request = RolloutRequest(uid=qreq.uid, inputs=remaining,
                                          x0=state)
            # original (arrival_time, seq) key: carried work re-seats
            # ahead of everything that queued behind it
            heapq.heappush(self._queue,
                           (qreq.arrival_time, qreq.seq, qreq))
            qreq.admit_time = None
            # wait accounting restarts at the rebuild; the heap key above
            # keeps the original priority
            qreq.arrival_time = self.now
            # it was already admitted once — carried work is never dropped
            # and never double-counted in the server's admission stats
            qreq.deadline = None
            qreq.requeued = True
        self.readmitted += len(carried)
        return len(carried)

    def shrink(self, failed: int = 1) -> dict:
        """Shard loss: rebuild on the survivors, lose nothing.

        Executes :func:`repro_torch.runtime.elastic.shrink_serve_plan`'s
        action list through :meth:`_rebuild`, keeping the first devices of
        the mesh.  Returns the plan dict (with ``n_shards`` before/after)
        for the caller's logs.
        """
        plan = shrink_serve_plan(self.n_shards, failed)
        new_n = max(plan["usable_devices"], 1)
        carried = self._rebuild(new_n)
        self.reshards += 1
        plan["n_shards_before"] = plan["survivors"] + failed
        plan["n_shards_after"] = new_n
        plan["readmitted"] = carried
        obs.event("shrink", failed=failed, n_shards_after=new_n,
                  readmitted=carried)
        obs.inc("shrinks_total")
        obs.set_gauge("n_shards", new_n)
        return plan

    def grow(self, added: int = 1) -> dict:
        """Elastic scale-up: admit ``added`` new shards under live
        traffic — the inverse of :meth:`shrink`.

        Executes :func:`repro_torch.runtime.elastic.grow_serve_plan`
        through the same snapshot/re-admit machinery: in-flight sequences
        resume from their carried states (bit-identical — each shard's
        launch shape is independent of the shard count), completed chunks
        are stitched as prefixes, nothing is dropped or re-run, and the
        least-loaded FIFO admission rebalances the sub-pools over the
        wider pool.  The target width is capped at the device pool's
        size.  Returns the executed plan dict.
        """
        plan = grow_serve_plan(self.n_shards, added,
                               max_shards=len(self.devices))
        new_n = plan["n_shards_after"]
        if new_n <= self.n_shards:
            plan["readmitted"] = 0
            return plan                   # nothing to add (device ceiling)
        carried = self._rebuild(new_n)
        self.grows += 1
        plan["readmitted"] = carried
        obs.event("grow", added=plan["added"], n_shards_after=new_n,
                  readmitted=carried)
        obs.inc("grows_total")
        obs.set_gauge("n_shards", new_n)
        return plan
