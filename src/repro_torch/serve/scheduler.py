"""Continuous-batching scheduler: decode-style admission for rollouts.

One-shot ``ReservoirEngine.submit_many()`` takes a fully-formed request
list, pads it, and blocks until the whole group is rolled.  Under streaming
arrivals that wastes time twice: the batch cannot start until its last
request exists, and every sequence is padded to the group's length bucket.
This module serves the same requests decode-style instead:

* a fixed pool of **batch slots** (the batch dimension never changes, so
  every chunk launches the same kernels at the same shape),
* the engine runs in fixed ``chunk_steps`` segments, and between chunks
  finished sequences **retire** and queued ones are **admitted mid-flight**,
* each live slot's reservoir state is carried across chunks through the
  engine's ``run_segment`` chunk API, so the chunked trajectory is
  bit-identical to a one-shot rollout of the same inputs — the CUDA
  kernels compute every row with the same arithmetic whatever the batch.

:class:`ContinuousBatcher` owns the slot pool mechanics;
:class:`AsyncReservoirServer` adds the time-stamped arrival queue, the
virtual clock, deadlines, and queue-wait / time-to-first-prediction /
slot-occupancy telemetry on :class:`~repro_torch.serve.stats.ServeStats`.
This is the single-model server: registry routing, admission policies and
server-driven fault plans are not ported yet and raise if passed.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.runtime.faults import TransientFault
from repro_torch.serve.api import RolloutResult, SubmitSpec, lifecycle_timings
from repro_torch.serve.batching import RolloutRequest
from repro_torch.serve.stats import ServeStats


@dataclasses.dataclass
class QueuedRequest:
    """A :class:`RolloutRequest` plus its arrival time and lifecycle marks.

    The scheduler fills the ``*_time`` fields as the request moves through
    the system (all on the server's clock): ``admit_time`` when it takes a
    slot, ``first_output_time`` when its first chunk of output is ready,
    ``finish_time`` when it retires.  ``deadline`` (absolute, same clock)
    bounds the queue wait: a request still queued past it is dropped —
    counted in ``ServeStats.timed_out`` — instead of occupying a slot.
    """

    request: RolloutRequest
    arrival_time: float = 0.0
    seq: int = 0                         # submission index; FIFO tiebreak
    admit_time: float | None = None
    first_output_time: float | None = None
    finish_time: float | None = None
    deadline: float | None = None
    want_states: bool | None = None      # None = the pool's default
    trace_id: str | None = None          # observability correlation id

    @property
    def uid(self) -> Any:
        return self.request.uid

    @property
    def length(self) -> int:
        return self.request.length


class _DeviceChunk:
    """One chunk's full (n_slots, cs, O) device output, shared by every
    sequence that rode in it and copied to the host at most once — when
    the first rider retires, never in the chunk loop.  At that copy every
    rider's entry is compacted to its own trimmed row copy."""

    __slots__ = ("dev",)

    def __init__(self, dev):
        self.dev = dev


class ContinuousBatcher:
    """A fixed pool of batch slots rolled forward ``chunk_steps`` at a time.

    Each chunk is one engine call per output contract (``want_states``) of
    the static shape ``(n_slots, chunk_steps, input_dim)`` — free slots
    ride along as inert rows — with the pool's reservoir states passed as
    ``x0`` and the post-chunk states carried through ``run_segment``.  Rows
    are independent through the recurrence, so a sequence's chunked
    trajectory equals its one-shot rollout bit for bit.
    """

    def __init__(self, engine, *, n_slots: int = 8, chunk_steps: int = 16,
                 want_states: bool | None = None,
                 zero_copy: bool | None = None):
        if n_slots < 1 or chunk_steps < 1:
            raise ValueError("n_slots and chunk_steps must be >= 1")
        self.engine = engine
        self.device = engine.device
        self.n_slots = n_slots
        self.chunk_steps = chunk_steps
        if want_states is None:
            want_states = not engine.has_readout
        self.want_states = want_states
        # zero-copy chunk serving: request inputs move to the device ONCE
        # at admission (into a resident (n_slots, max_chunks, cs, I)
        # buffer), one index_select assembles each chunk's input
        # on-device, the kernel writes each chunk's final state into the
        # carried state buffer in place, chunk outputs stay device-side,
        # and the only device->host copies happen at slot retirement
        # (``host_syncs`` counts them).  On by default on a CUDA device;
        # on the CPU a "transfer" is a memcpy, so the host-assembled path
        # is the default there.  Both paths give identical outputs.
        if zero_copy is None:
            zero_copy = self.device.type == "cuda"
        self.zero_copy = zero_copy
        self.host_syncs = 0
        self._in_dim = engine.config.input_dim
        self._dim = engine.config.reservoir_dim
        self._slots: list[QueuedRequest | None] = [None] * n_slots
        self._pos = [0] * n_slots               # steps consumed per slot
        self._chunks: list[list] = [[] for _ in range(n_slots)]
        self._states = torch.zeros((n_slots, self._dim), device=self.device)
        self._max_chunks = 4                    # input lanes; doubles on
        #                                         demand (longer requests)
        if zero_copy:
            self._u_dev = torch.zeros(
                (n_slots, self._max_chunks, chunk_steps, self._in_dim),
                device=self.device)
        # fault injection: transient engine-call failures raised by an
        # attached FaultPlan are retried here with capped exponential
        # backoff; the backoff and retry count of the last chunk land in
        # last_backoff_s / last_retries for the server to account
        self.fault_plan = None
        self.last_backoff_s = 0.0
        self.last_retries = 0
        self.warm()

    def _want_of(self, qreq: QueuedRequest) -> bool:
        return (self.want_states if qreq.want_states is None
                else qreq.want_states)

    def warm(self) -> None:
        """Build the kernels and run the pool's chunk shape once, off the
        serving clock (bypasses the engine's public API so warmup never
        pollutes ``ServeStats``)."""
        want_states = self.want_states if self.engine.has_readout else True
        u = torch.zeros((self.n_slots, self.chunk_steps, self._in_dim),
                        device=self.device)
        x0 = torch.zeros((self.n_slots, self._dim), device=self.device)
        self.engine._dispatch(u, x0, not want_states, True, self.zero_copy)
        self.engine._sync()

    @property
    def live(self) -> int:
        return sum(s is not None for s in self._slots)

    def has_free_slot(self) -> bool:
        return any(s is None for s in self._slots)

    def admit(self, qreq: QueuedRequest) -> int:
        """Seat a request in a free slot (zero state, or its ``x0``)."""
        if not self._want_of(qreq) and not self.engine.has_readout:
            raise ValueError(
                "readout not trained on the serving engine; submit with "
                "want_states=True")
        slot = self._slots.index(None)
        self._slots[slot] = qreq
        self._pos[slot] = 0
        self._chunks[slot] = []
        if self.zero_copy:
            # ONE host->device copy per request: the whole input, cut into
            # chunk_steps segments, lands in the slot's lane of the
            # resident input buffer (in-place slice write).  Lanes double
            # when a request is longer than any seen before.
            cs = self.chunk_steps
            seg = np.asarray(qreq.request.inputs, np.float32)
            n_chunks = max(1, -(-seg.shape[0] // cs))
            if n_chunks > self._max_chunks:
                while n_chunks > self._max_chunks:
                    self._max_chunks *= 2
                grown = torch.zeros(
                    (self.n_slots, self._max_chunks, cs, self._in_dim),
                    device=self.device)
                grown[:, : self._u_dev.shape[1]] = self._u_dev
                self._u_dev = grown
            padded = np.zeros((self._max_chunks * cs, self._in_dim),
                              np.float32)
            padded[: seg.shape[0]] = seg
            self._u_dev[slot].copy_(torch.from_numpy(padded).view(
                self._max_chunks, cs, self._in_dim))
        x0 = qreq.request.x0
        if x0 is None:
            self._states[slot].zero_()
        else:
            self._states[slot].copy_(torch.as_tensor(x0,
                                                     dtype=torch.float32))
        return slot

    def run_chunk(self) -> tuple[list[tuple[QueuedRequest, np.ndarray]], int]:
        """Roll every slot ``chunk_steps`` forward.

        Returns ``(retired, real_steps)``: each retiree is
        ``(qreq, output)`` with the full (T_request, O/R) output assembled
        from its chunks, and ``real_steps`` counts the input steps the
        chunk actually consumed (the occupancy numerator).  Sequences that
        finish inside the chunk stop accumulating output at their real
        length (the recurrence is causal, so the zero-padded tail steps
        cannot reach them).  Occupied slots are grouped by output
        contract; each group is one full-pool call and the post-chunk
        states merge by exact row selection (``torch.where``).
        """
        cs = self.chunk_steps
        take: dict[int, int] = {}
        if self.zero_copy:
            # ONE gather assembles the (n_slots, cs, I) chunk from the
            # device-resident input buffer.  Free slots gather lane 0:
            # their output is discarded and their state re-seeded at
            # admission, so the rows are inert ballast.
            idx = np.zeros(self.n_slots, np.int64)
            for i, q in enumerate(self._slots):
                if q is None:
                    continue
                idx[i] = self._pos[i] // cs
                take[i] = min(cs, q.length - self._pos[i])
            flat = self._u_dev.view(-1, cs, self._in_dim)
            lanes = torch.as_tensor(
                np.arange(self.n_slots) * self._max_chunks + idx,
                device=self.device)
            u = flat.index_select(0, lanes)
        else:
            u_host = np.zeros((self.n_slots, cs, self._in_dim), np.float32)
            for i, q in enumerate(self._slots):
                if q is None:
                    continue
                seg = np.asarray(
                    q.request.inputs[self._pos[i]:self._pos[i] + cs],
                    np.float32)
                u_host[i, :len(seg)] = seg
                take[i] = len(seg)
            u = torch.from_numpy(u_host).to(self.device)
        groups: dict[bool, list[int]] = {}
        for i, q in enumerate(self._slots):
            if q is not None:
                groups.setdefault(self._want_of(q), []).append(i)
        if not groups:
            # empty pool (direct run_chunk call): one inert full-pool roll
            groups = {self.want_states: []}
        single = len(groups) == 1
        prev = self._states
        new_states = None
        self.last_backoff_s = 0.0
        self.last_retries = 0
        for want, slots in groups.items():
            # one group: the kernel writes the final state into the carried
            # buffer in place.  With several groups every call reads
            # ``prev``, so none may overwrite it; an attached fault plan
            # also keeps ``prev`` intact so a retry replays from it.
            donate = self.zero_copy and single and self.fault_plan is None
            out, xf = self._faulting_call(
                u, prev, want=want,
                real_steps=sum(take.get(i, 0) for i in slots),
                donate=donate)
            if single:
                new_states = xf
            else:
                sel = torch.zeros(self.n_slots, dtype=torch.bool,
                                  device=self.device)
                sel[slots] = True
                new_states = torch.where(
                    sel[:, None], xf,
                    prev if new_states is None else new_states)
            if self.zero_copy:
                chunk = _DeviceChunk(out)
                for i in slots:
                    self._chunks[i].append((chunk, take[i]))
            else:
                self.host_syncs += 1
                out_h = out.cpu().numpy()
                for i in slots:
                    self._chunks[i].append(out_h[i, :take[i]].copy())
        self._states = new_states
        for i, n in take.items():
            self._pos[i] += n
        retired = []
        # retire in a second pass: a retirement materializes the shared
        # chunk buffer (rewriting every rider's entry), so every rider
        # must have its entry before the first retiree triggers that
        for i in take:
            q = self._slots[i]
            if self._pos[i] >= q.length:
                retired.append((q, self._assemble(i)))
                self._slots[i] = None
                self._chunks[i] = []
        return retired, sum(take.values())

    def _faulting_call(self, u, prev, *, want, real_steps, donate):
        """One chunk launch under the (optional) fault plan.

        An injected :class:`~repro_torch.runtime.faults.TransientFault` is
        retried with capped exponential backoff *from the slots' last
        carried state*: ``u`` and ``prev`` are untouched by the failed
        attempt (nothing is donated while a plan is attached), so the
        retry runs the same kernels on the same operands — a bit-identical
        replay.  The accumulated backoff lands in ``last_backoff_s``.
        """
        fp = self.fault_plan
        attempt = 0
        while True:
            try:
                if fp is not None:
                    fp.check_call()
                return self.engine.run_segment(
                    u, prev, want_states=want, real_steps=real_steps,
                    donate_state=donate, defer_sync=self.zero_copy)
            except TransientFault:
                if attempt >= fp.max_attempts:
                    raise
                self.last_backoff_s += fp.backoff_s(attempt)
                self.last_retries += 1
                attempt += 1
                obs.inc("engine_call_retries_total")

    def _materialize(self, chunk: _DeviceChunk) -> None:
        """THE deferred device->host copy, paid once per chunk buffer no
        matter how many riders retire from it.  Every rider's entry is
        rewritten to its own trimmed row copy, so the full-width buffer
        (device AND host) is immediately collectable."""
        host = chunk.dev.cpu().numpy()
        chunk.dev = None
        self.host_syncs += 1
        for s, entries in enumerate(self._chunks):
            for j, (c, n) in enumerate(entries):
                if c is chunk:
                    entries[j] = (host[s, :n].copy(), n)

    def _assemble(self, slot: int) -> np.ndarray:
        """Concatenate a retiring slot's chunks into its full output (the
        zero-copy path copies each shared buffer to the host here, at most
        once)."""
        entries = self._chunks[slot]
        if not self.zero_copy:
            return np.concatenate(entries, axis=0)
        for idx in range(len(entries)):
            if isinstance(entries[idx][0], _DeviceChunk):
                self._materialize(entries[idx][0])   # rewrites entries[idx]
        return np.concatenate([row for row, _n in entries], axis=0)


class AsyncReservoirServer:
    """Time-stamped request queue in front of a :class:`ContinuousBatcher`.

    ``submit()`` enqueues :class:`SubmitSpec` requests with arrival
    timestamps; ``run()`` (or repeated ``step()`` calls) drains the queue:
    admit every arrived request that fits the pool, roll one chunk, retire
    finished sequences, repeat.  Admission is strictly FIFO in
    (arrival_time, submission order).

    The server keeps a virtual clock ``now``: it advances by each chunk's
    measured wall time (or the fixed ``chunk_time`` if given — for
    deterministic tests and trace-driven benchmarks) and jumps forward to
    the next arrival when the pool runs empty.  Queue waits,
    time-to-first-prediction and slot occupancy land in ``stats``.
    """

    def __init__(self, engine, *, n_slots: int = 8, chunk_steps: int = 16,
                 want_states: bool | None = None,
                 stats: ServeStats | None = None,
                 chunk_time: float | None = None,
                 batcher: ContinuousBatcher | None = None,
                 zero_copy: bool | None = None,
                 registry=None, admission=None, fault_plan=None):
        for name, value in (("registry", registry), ("admission", admission),
                            ("fault_plan", fault_plan)):
            if value is not None:
                raise NotImplementedError(
                    f"{name}= is not ported yet (single-model server); "
                    "see ROADMAP items A7 and A9")
        if batcher is None:
            batcher = ContinuousBatcher(
                engine, n_slots=n_slots, chunk_steps=chunk_steps,
                want_states=want_states, zero_copy=zero_copy)
        self.batcher = batcher
        self.stats = stats if stats is not None else engine.stats
        self.chunk_time = chunk_time
        self.now = 0.0
        self.results: dict[Any, Any] = {}
        self.admission_order: list = []        # uids in the order seated
        self._queue: list[tuple[float, int, QueuedRequest]] = []
        self._seq = 0

    # -- queue ---------------------------------------------------------------
    def submit(self, spec: SubmitSpec, arrival_time: float | None = None,
               deadline: float | None = None) -> QueuedRequest:
        """Enqueue one :class:`SubmitSpec`; ``arrival_time`` defaults to
        ``now``.  ``deadline`` (or ``spec.deadline``, which wins) is an
        absolute time on the server's clock: a request still waiting in
        the queue past it is dropped (``timed_out`` in stats) rather than
        seated.  A request already in a slot always runs to completion."""
        if not isinstance(spec, SubmitSpec):
            raise TypeError("submit takes a SubmitSpec")
        if spec.model is not None:
            raise ValueError(
                f"SubmitSpec routes to model {spec.model!r}, but model "
                "routing (the registry) is not ported yet")
        at = self.now if arrival_time is None else float(arrival_time)
        uid = spec.uid if spec.uid is not None else f"req{self._seq}"
        dl = spec.deadline if spec.deadline is not None else deadline
        inputs = spec.inputs
        if isinstance(inputs, torch.Tensor):
            inputs = inputs.detach().cpu().numpy()
        qreq = QueuedRequest(
            RolloutRequest(uid, np.asarray(inputs, np.float32), x0=spec.x0),
            arrival_time=at, seq=self._seq,
            deadline=None if dl is None else float(dl),
            want_states=spec.want_states,
            trace_id=spec.trace_id or obs.new_trace_id())
        self._seq += 1
        heapq.heappush(self._queue, (at, qreq.seq, qreq))
        self.stats.record_enqueue()
        obs.inc("requests_submitted_total")
        obs.span("request.enqueue", at, trace_id=qreq.trace_id,
                 clock="server", uid=str(qreq.uid))
        return qreq

    @property
    def drained(self) -> bool:
        return not self._queue and self.batcher.live == 0

    def _timeout(self, qreq: QueuedRequest) -> None:
        """Bookkeeping for one queued request dropped past its deadline."""
        self.stats.record_timeout()
        obs.inc("requests_timed_out_total")
        obs.span("request.timeout", self.now, trace_id=qreq.trace_id,
                 clock="server", uid=str(qreq.uid))

    def _drop_expired(self) -> None:
        """Drop every *arrived* queued request whose deadline has passed —
        called on every clock advance, so a request waiting behind a full
        pool is dropped the step its deadline passes."""
        expired = [entry for entry in self._queue
                   if (entry[2].deadline is not None
                       and entry[0] <= self.now
                       and self.now > entry[2].deadline)]
        if not expired:
            return
        dropped = {id(entry[2]) for entry in expired}
        self._queue = [entry for entry in self._queue
                       if id(entry[2]) not in dropped]
        heapq.heapify(self._queue)
        for _, _, qreq in expired:
            self._timeout(qreq)

    def _admit_arrived(self) -> None:
        while self._queue and self._queue[0][0] <= self.now:
            qreq = self._queue[0][2]
            if qreq.deadline is not None and self.now > qreq.deadline:
                heapq.heappop(self._queue)
                self._timeout(qreq)
                continue
            if not self.batcher.has_free_slot():
                break
            heapq.heappop(self._queue)
            qreq.admit_time = self.now
            slot = self.batcher.admit(qreq)
            self.admission_order.append(qreq.uid)
            wait = self.now - qreq.arrival_time
            self.stats.record_admission(wait)
            obs.observe("queue_wait_seconds", wait)
            obs.span("request.queued", qreq.arrival_time, self.now,
                     trace_id=qreq.trace_id, clock="server",
                     uid=str(qreq.uid), slot=slot)

    # -- results -------------------------------------------------------------
    def _package(self, qreq: QueuedRequest, out) -> RolloutResult:
        want = self.batcher._want_of(qreq)
        return RolloutResult(preds=None if want else out,
                             states=out if want else None,
                             timings=lifecycle_timings(
                                 arrival_time=qreq.arrival_time,
                                 admit_time=qreq.admit_time,
                                 finish_time=qreq.finish_time,
                                 first_output_time=qreq.first_output_time,
                                 trace_id=qreq.trace_id))

    # -- event loop ----------------------------------------------------------
    def step(self) -> bool:
        """Admit + one chunk + retire.  Returns False once drained."""
        if self.drained:
            return False
        if self.batcher.live == 0 and self._queue:
            # pool idle: fast-forward the clock to the next arrival
            self.now = max(self.now, self._queue[0][0])
        self._admit_arrived()
        if self.batcher.live == 0:
            # everything at the head expired (or only future arrivals are
            # left): no chunk to run this step
            return not self.drained
        t0 = time.perf_counter()
        chunk_start = self.now
        retired, real_steps = self.batcher.run_chunk()
        wall = time.perf_counter() - t0
        dt = wall if self.chunk_time is None else self.chunk_time
        # retry backoff from transient failures is time the requests
        # really waited
        self.now += dt + self.batcher.last_backoff_s
        for _ in range(self.batcher.last_retries):
            self.stats.record_retry()
        self._drop_expired()
        self.stats.record_chunk(
            live_steps=real_steps,
            total_steps=self.batcher.n_slots * self.batcher.chunk_steps)
        obs.span("scheduler.chunk", chunk_start, self.now, clock="server",
                 live_steps=real_steps, retired=len(retired))
        obs.observe("chunk_seconds", wall)
        for qreq, out in retired:
            qreq.finish_time = self.now
            latency = self.now - qreq.arrival_time
            self.results[qreq.uid] = self._package(qreq, out)
            self.stats.record_completion(latency)
            obs.observe("request_latency_seconds", latency,
                        path="scheduler")
            obs.inc("requests_completed_total")
            obs.span("request.serve", qreq.admit_time, self.now,
                     trace_id=qreq.trace_id, clock="server",
                     uid=str(qreq.uid))
        # first-output marks: every seated-or-just-retired request that has
        # produced output by the end of this chunk
        for qreq in list(self.batcher._slots) + [q for q, _ in retired]:
            if (qreq is not None and qreq.first_output_time is None
                    and qreq.admit_time is not None):
                qreq.first_output_time = self.now
                ttfp = self.now - qreq.arrival_time
                self.stats.record_first_output(ttfp)
                obs.observe("ttfp_seconds", ttfp)
                obs.span("request.first_output", self.now,
                         trace_id=qreq.trace_id, clock="server",
                         uid=str(qreq.uid))
                res = self.results.get(qreq.uid)
                if res is not None:
                    res.timings["first_output_time"] = self.now
                    res.timings["ttfp_s"] = ttfp
        return True

    def run(self) -> dict:
        """Drain the queue; returns ``{uid: RolloutResult}``."""
        while self.step():
            pass
        return self.results


__all__ = ["QueuedRequest", "ContinuousBatcher", "AsyncReservoirServer"]
