"""Batched reservoir-rollout engine — the serving face of the paper.

The paper's win is specializing the *recurrent* multiply of a frozen
reservoir; serving-side, the unit of work is therefore the whole rollout
``x(n) = f(W_in u(n) + W x(n-1))`` over a request batch, not a single gemv.
Every backend builds from the one shared
:class:`repro_torch.plan.ExecutionPlan` lowering of the reservoir matrix
and fronts two implementations:

* ``cuda``  — the CUDA rollout kernels, one launch per call for all T
  steps with the readout fused: ``specialize=True`` (default) runs
  :class:`SpecializedRollout` (folded int8 tiles + shift-add digits),
  ``specialize=False`` :class:`FusedRollout`, the generic banded kernel
  every specialized schedule is held bit-identical to.  On a CPU device
  both run their plain PyTorch twins.
* ``torch`` — a per-step loop of PyTorch ops, the counterpart of the JAX
  package's ``xla`` scan: the input projection hoisted into one
  (B*T, I) x (I, R) product, the recurrent product dense or block-culled
  (dispatched on the plan's block density), int8 through exact integer
  products, the readout applied after the loop.

``backend="auto"`` resolves through the plan autotuner
(:mod:`repro_torch.plan.autotune`): a persisted tuning cache replays the
measured winner, a cold cache takes the cost model's pick for the
engine's device.  With a trained readout the engine serves
*predictions*, so the state trajectory never leaves the engine on the
prediction path.  The request/response surface is the
:class:`~repro_torch.serve.api.SubmitSpec` ->
:class:`~repro_torch.serve.api.RolloutResult` contract (``submit`` /
``submit_many``); the chunked scheduler drives :meth:`run_segment`.
"""

from __future__ import annotations

import collections
import time
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.esn import ESNParams
from repro_torch.core.sparse import int_matmul_exact
from repro_torch.device import ieee_fp32, resolve_device
from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
from repro_torch.kernels.reservoir_rollout.specialized import \
    SpecializedRollout
from repro_torch.plan import (DEFAULT_BATCH_TILE, DEFAULT_VMEM_BUDGET,
                              plan_for, specialize_rollout)
from repro_torch.plan.autotune import resolve_backend, resolve_schedule
from repro_torch.plan.specialize import int8_recur_reference
from repro_torch.serve.api import (_UNSET, RolloutResult, SubmitSpec,
                                   lifecycle_timings)
from repro_torch.serve.batching import (MicroBatch, PaddingBucketer,
                                        RolloutRequest)
from repro_torch.serve.stats import ServeStats

# one process-wide warning for deadline-bearing specs on the one-shot
# path (the result still records timings["deadline_ignored"] every time)
_WARNED_DEADLINE = False

BACKENDS = ("auto", "torch", "cuda")

# Below this nonzero-block density the culled block loop beats one dense
# (B, R) x (R, R) product; above it the dense product wins.  Reservoirs at
# the paper's element sparsities (0.75-0.9) have dense *block* structure at
# block 128, so they take the dense path; block-structured matrices take
# the culled loop.  The JAX package's value, so both pick one schedule.
DENSE_DISPATCH_DENSITY = 0.5


class ReservoirEngine:
    """Batched rollout (and readout) for one frozen ESN on one device.

    ``backend`` is ``"cuda"`` (the rollout kernels), ``"torch"`` (the
    per-step PyTorch loop) or ``"auto"``: with ``specialize=True`` the
    plan autotuner's schedule for the engine's device, without it
    ``"cuda"`` on a CUDA device and ``"torch"`` on the CPU.  ``schedule``
    (a :class:`~repro_torch.plan.autotune.Schedule` or
    :class:`~repro_torch.plan.autotune.TunedSchedule`) bypasses
    resolution; a schedule fills only the knobs the caller left unset.
    ``vmem_budget`` bands only the torch backend's culled int8 program:
    the CUDA ops take no budget.  ``device`` defaults to the params'
    device.  ``tenant`` is the registry model name the engine serves
    (None outside a registry); it threads through to the plan-cache
    tenant counters.
    """

    def __init__(self, params: ESNParams, *, backend: str = "auto",
                 stats: ServeStats | None = None,
                 dense_dispatch_density: float = DENSE_DISPATCH_DENSITY,
                 vmem_budget: int | None = _UNSET,
                 specialize: bool = True, tenant: str | None = None,
                 crossover: int | None = None,
                 batch_tile_max: int | None = None, schedule=None,
                 device=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"not {backend!r}")
        self.params = params
        self.config = params.config
        self.device = resolve_device(params.device if device is None
                                     else device)
        self.stats = stats if stats is not None else ServeStats()
        self.tenant = tenant
        self.plan = plan_for(params.w, tenant=tenant)
        self.specialize = specialize
        self._int8 = self.config.mode.startswith("int8")
        # backend="auto" resolves through the plan autotuner: a persisted
        # tuning cache replays the measured winner, a cold cache falls
        # back to the cost model's pick for this device.  The schedule
        # fills every knob the caller left unset; explicit kwargs always
        # win.  ``schedule`` bypasses resolution entirely.
        self.requested_backend = backend
        if schedule is None and backend == "auto" and specialize:
            schedule = resolve_schedule(
                self.plan, "int8" if self._int8 else "fp32",
                device=self.device)
        sched = getattr(schedule, "schedule", schedule)
        self.schedule = sched
        if sched is not None:
            self.backend = sched.backend if backend == "auto" else backend
            if vmem_budget is _UNSET:
                vmem_budget = sched.vmem_budget
            if crossover is None:
                crossover = sched.crossover
            if batch_tile_max is None:
                batch_tile_max = sched.batch_tile_max
        else:
            self.backend = (_unspecialized_auto(self.device)
                            if backend == "auto" else backend)
        self.vmem_budget = DEFAULT_VMEM_BUDGET if vmem_budget is _UNSET \
            else vmem_budget
        self.crossover = crossover
        self.batch_tile_max = batch_tile_max
        # readout captured at construction; engine_for invalidates the
        # cached engine when params.w_out is replaced (fit_readout)
        self._w_out = params.w_out
        # plan.block_density (not plan.stats) keeps the fp32 path from
        # paying for the integer lowering just to make a dispatch decision
        self.uses_dense = (not self._int8 and
                           self.plan.block_density >= dense_dispatch_density)
        # specialized int8: block-dense matrices take one folded integer
        # product (the whole digit-plane fold), block-sparse ones the
        # program's culled folded/shift-add schedule
        self._int8_dense = (self._int8 and specialize and
                            self.plan.block_density >= dense_dispatch_density)
        # one tick per (shape, outputs, donate, schedule) key the first
        # time it is dispatched: the warm-up guard (N chunks of one shape
        # must set up once, and a prewarm must cover what serving runs)
        self._traces: collections.Counter = collections.Counter()
        obs.event("engine_build", backend=self.backend, tenant=tenant,
                  device=str(self.device), specialize=specialize,
                  schedule=str(self.schedule))
        obs.inc("engine_builds_total", backend=self.backend)
        if self.backend == "cuda":
            kw = {}
            if specialize:
                kw = {"crossover": crossover,
                      "batch_tile_max": batch_tile_max or DEFAULT_BATCH_TILE}
            cls = SpecializedRollout if specialize else FusedRollout
            self._fused = cls(
                self.plan, params.w_in, leak=self.config.leak,
                mode="int8" if self._int8 else "fp32",
                state_bits=self.config.state_bits, w_out=self._w_out,
                device=self.device, **kw)
        else:
            self._build_torch()

    # -- torch scan backend --------------------------------------------------
    def _build_torch(self) -> None:
        """Place every operand of the per-step loop on the device once:
        the loop runs T steps per call and must copy nothing from the
        host per step."""
        dev, w = self.device, self.params.w
        as_f32 = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=torch.float32, device=dev).contiguous()
        self._w_in = as_f32(self.params.w_in)
        self._w_out_dev = None if self._w_out is None else as_f32(self._w_out)
        self._smax = (1 << (self.config.state_bits - 1)) - 1
        self._w_dense = self._tiles = self._q_folded = None
        self._program = self._program_data = self._planes = None
        schedule = self.torch_schedule
        if schedule == "fp32-dense":
            self._w_dense = w.dense_f32(device=dev)
        elif schedule == "fp32-culled":
            self._tiles = as_f32(w.blocks.data)
        elif schedule == "int8-folded-dense":
            # folded once here: converting (R, R) per step would cost
            # more than the product (float64 holds every int8 partial sum
            # exactly, the operand type of int_matmul_exact)
            self._q_folded = torch.as_tensor(w.q, device=dev).to(
                torch.float64)
        elif schedule == "int8-folded-culled":
            self._program = specialize_rollout(
                self.plan, "int8", vmem_budget=self.vmem_budget,
                crossover=self.crossover,
                batch_tile_max=self.batch_tile_max or DEFAULT_BATCH_TILE)
            self._program_data = torch.as_tensor(
                self._program.data, device=dev).to(torch.float64)
        else:
            self._planes = w.device_planes(dev)

    def _int_product(self, xq: torch.Tensor) -> torch.Tensor:
        """The exact int32 ``xq @ q`` of an int8 schedule."""
        if self._q_folded is not None:
            return int_matmul_exact(xq, self._q_folded)
        if self._program is not None:
            return int8_recur_reference(self._program, xq,
                                        self.plan.rows_pad,
                                        self.config.reservoir_dim,
                                        data=self._program_data)
        return self.params.w.matvec_int_exact(xq, planes=self._planes)

    def _recur(self, x: torch.Tensor) -> torch.Tensor:
        """The recurrent product ``x @ W`` of one step, in the schedule
        :attr:`torch_schedule` names."""
        if self._int8:
            smax = self._smax
            xq = torch.clamp(torch.round(x * smax), -smax - 1,
                             smax).to(torch.int32)
            ri = self._int_product(xq)
            return ri.to(torch.float32) * (self.params.w.scale / smax)
        if self._w_dense is not None:
            return x @ self._w_dense
        return self.params.w.blocks.matmul_ref(x, tiles=self._tiles)

    def _torch_rollout(self, u, x0b, with_readout: bool):
        """(B, T, I), (B, R) -> (B, T, R or O) and x(T): T steps of Eq. 1,
        one Python iteration (a handful of launches) per step."""
        leak = self.config.leak
        b, t, i = u.shape
        # one product projects every input of every step before the loop
        uproj = (u.reshape(b * t, i) @ self._w_in).view(b, t, -1)
        x = x0b
        states = []
        for n in range(t):
            nxt = torch.tanh(uproj[:, n] + self._recur(x))
            x = (1.0 - leak) * x + leak * nxt
            states.append(x)
        if with_readout:
            # one (B, R) x (R, O) product per step: its shape does not
            # depend on T, so chunked predictions equal one-shot ones bit
            # for bit (a GEMM library picks its sum order by shape)
            states = [s @ self._w_out_dev for s in states]
        return torch.stack(states, dim=1), x

    # -- backend dispatch ----------------------------------------------------
    @property
    def torch_schedule(self) -> str:
        """Which recurrent product the torch backend runs (the JAX
        package's ``xla_schedule`` strings)."""
        if not self._int8:
            return "fp32-dense" if self.uses_dense else "fp32-culled"
        if self._int8_dense:
            return "int8-folded-dense"
        if self.specialize:
            return "int8-folded-culled"
        return "int8-planes"

    @property
    def program(self):
        """The cuda backend's :class:`~repro_torch.plan.RolloutProgram`
        (None on the torch backend or with ``specialize=False``)."""
        return getattr(getattr(self, "_fused", None), "program", None)

    @property
    def trace_counts(self) -> collections.Counter:
        """Rollouts set up per (shape, outputs, final, schedule) key — the
        warm-up guard: rolling N chunks of one shape must leave every
        count at exactly 1, and a prewarm must leave nothing for serving
        to set up.  Unlike the JAX package's key it has no ``donate``: a
        donated call is no separate program here, only another output
        buffer for the final state."""
        return collections.Counter(self._traces)

    @property
    def has_readout(self) -> bool:
        """Whether a trained ``W_out`` is baked into this engine (serving
        defaults to predictions when True, states otherwise)."""
        return self._w_out is not None

    def _note_key(self, shape, with_readout, with_final) -> None:
        schedule = (self.torch_schedule if self.backend == "torch"
                    else self._fused.__class__.__name__)
        key = (tuple(shape), with_readout, with_final, schedule)
        if key not in self._traces:
            self._traces[key] += 1
            obs.event("rollout_setup", backend=self.backend,
                      shape=str(tuple(shape)), schedule=schedule)
            obs.inc("compile_traces_total", backend=self.backend)

    def _dispatch(self, u, x0b, with_readout: bool, with_final: bool,
                  donate: bool = False):
        """One rollout call ``(B, T, I), (B, R) -> (out, final_or_None)``.

        ``out`` is (B, T, O) predictions or (B, T, R) states.  ``donate``
        writes the final state into ``x0b`` in place (and returns it)."""
        self._note_key(u.shape, with_readout, with_final)
        if self.backend == "torch":
            if donate and not (isinstance(x0b, torch.Tensor)
                               and x0b.is_contiguous()
                               and x0b.dtype == torch.float32
                               and x0b.device == self.device):
                raise ValueError("donate_state needs x0 as a contiguous "
                                 "float32 tensor on the engine's device")
            with ieee_fp32(self.device):
                y, xf = self._torch_rollout(u, x0b, with_readout)
            if donate:
                xf = x0b.copy_(xf)
            return y, (xf if with_final else None)
        # the kernels' outputs are (T, B, *); ``y`` is a transposed view
        out = self._fused(u.transpose(0, 1), x0b,
                          want_states=not with_readout,
                          want_preds=with_readout, want_final=with_final,
                          donate_state=donate)
        y, xf = out if with_final else (out, None)
        return y.transpose(0, 1), xf

    def _as_input(self, inputs) -> torch.Tensor:
        return torch.as_tensor(inputs, dtype=torch.float32,
                               device=self.device)

    def _prepare(self, inputs, x0):
        u = self._as_input(inputs)
        single = u.ndim == 2
        if single:
            u = u[None]
        b = u.shape[0]
        dim = self.config.reservoir_dim
        if x0 is None:
            x0b = torch.zeros((b, dim), device=self.device)
        else:
            x0b = torch.as_tensor(x0, dtype=torch.float32,
                                  device=self.device)
            if x0b.ndim == 1:
                x0b = x0b.expand(b, dim)
            x0b = x0b.contiguous()
        return u, x0b, single

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _record(self, batch, steps, t0, real_steps, defer=False):
        # defer=True is the zero-copy serve loop: no host sync per chunk —
        # the recorded time is dispatch-side only (the device->host wait
        # lands at slot retirement), so the call is flagged in the stats
        # and throughput should be read from the scheduler's clock.
        tracer = None if defer else obs.tracer()
        t_sync = 0.0 if tracer is None else time.perf_counter()
        if not defer:
            self._sync()
        now = time.perf_counter()
        if tracer is not None:
            tracer.record("engine.sync", t_sync, now)
        self.stats.record_call(batch=batch, steps=steps, seconds=now - t0,
                               real_steps=real_steps, deferred=defer)

    def _resolve_want(self, want_states: bool | None) -> bool:
        want = (not self.has_readout) if want_states is None \
            else bool(want_states)
        if not want and self._w_out is None:
            raise ValueError("readout not trained; call fit_readout first "
                             "(or submit with want_states=True)")
        return want

    # -- public API ----------------------------------------------------------
    def run_segment(self, inputs, x0, *, want_states: bool = False,
                    real_steps: int | None = None,
                    donate_state: bool = False, defer_sync: bool = False):
        """The chunk-serving primitive: ``(B, T, I), (B, R) -> (out, x_end)``.

        One rollout of a batch segment from the carried states, ALWAYS
        returning the post-segment states — the carry the next segment
        resumes from bit-identically.  ``donate_state=True`` writes x_end
        into the caller's ``x0`` buffer in place (and returns it), and
        ``defer_sync=True`` skips the per-call device sync so the serve
        loop only waits for the device at slot retirement.
        """
        if not want_states and self._w_out is None:
            raise ValueError("readout not trained; call fit_readout first "
                             "(or run the segment with want_states=True)")
        u = self._as_input(inputs)
        if donate_state:
            x0b = x0
        else:
            x0b = torch.as_tensor(x0, dtype=torch.float32,
                                  device=self.device).contiguous()
        b, t = u.shape[0], u.shape[1]
        t0 = time.perf_counter()
        out, xf = self._dispatch(u, x0b, not want_states, True, donate_state)
        self._record(b, t, t0, real_steps, defer=defer_sync)
        return out, xf

    def submit(self, spec: SubmitSpec) -> RolloutResult:
        """One-shot serve of a single :class:`SubmitSpec`.

        ``inputs`` may be (T, I) or pre-batched (B, T, I); the result's
        ``preds``/``states``/``final_state`` match that leading shape.
        ``final_state`` is exactly x(T) — the chunk-resume carry.
        ``spec.deadline`` cannot be enforced here (no queue to wait in):
        a spec carrying one warns once per process and the result records
        ``timings["deadline_ignored"] = True``.  The request's time runs
        from this call's entry to its return.
        """
        t0 = time.perf_counter()
        if spec.model is not None:
            raise ValueError(
                f"spec routes to model {spec.model!r} but this is a bare "
                "single-model engine; submit through a registry-backed "
                "server (or ModelRegistry.submit)")
        deadline_ignored = spec.deadline is not None
        if deadline_ignored:
            global _WARNED_DEADLINE
            if not _WARNED_DEADLINE:
                _WARNED_DEADLINE = True
                warnings.warn(
                    "SubmitSpec.deadline is ignored by one-shot "
                    "ReservoirEngine.submit (there is no queue to wait "
                    "in); submit through AsyncReservoirServer to get "
                    "deadline enforcement", UserWarning, stacklevel=2)
        want = self._resolve_want(spec.want_states)
        trace_id = spec.trace_id or obs.new_trace_id()
        # the request's span tree: engine.prepare, rollout.launch (the
        # kernels layer) and engine.sync join it as children
        tracer = obs.open_span("request.serve", t0, trace_id=trace_id)
        try:
            t_prep = 0.0 if tracer is None else time.perf_counter()
            u, x0b, single = self._prepare(spec.inputs, spec.x0)
            if tracer is not None:
                tracer.record("engine.prepare", t_prep, time.perf_counter())
            b, t, _ = u.shape
            out, xf = self._dispatch(u, x0b, not want, True)
            self._record(b, t, t0, None)
            if single:
                out, xf = out[0], xf[0]
            result = RolloutResult(preds=None if want else out,
                                   states=out if want else None,
                                   final_state=xf, timings={})
        except BaseException:
            if tracer is not None:
                tracer.close(failed=True)
            raise
        finish = time.perf_counter()
        if tracer is not None:
            tracer.close(finish, batch=b, steps=t)
        obs.observe("request_latency_seconds", finish - t0, path="engine")
        result.timings.update(lifecycle_timings(
            arrival_time=t0, admit_time=t0, finish_time=finish,
            seconds=finish - t0, trace_id=trace_id))
        if deadline_ignored:
            result.timings["deadline_ignored"] = True
        return result

    def submit_many(self, specs: Sequence[SubmitSpec],
                    bucketer: PaddingBucketer | None = None) -> dict:
        """Batch, pad and roll a set of variable-length specs.

        Returns ``{uid: RolloutResult}`` (specs without a ``uid`` get
        ``req<position>``).  Specs sharing a resolved ``want_states`` ride
        the same padded microbatches; padding overhead lands in
        ``self.stats``.  ``final_state`` is ``None`` on this path (the
        padded batch rolls past each request's real length).  A spec's
        ``x0`` seeds its row of the padded batch.
        """
        bucketer = bucketer or PaddingBucketer()
        groups: dict[bool, list] = {}
        tids: dict = {}
        for i, spec in enumerate(specs):
            if spec.model is not None:
                raise ValueError(
                    f"spec routes to model {spec.model!r}; submit through "
                    "a registry-backed server")
            want = self._resolve_want(spec.want_states)
            uid = spec.uid if spec.uid is not None else f"req{i}"
            tids[uid] = spec.trace_id or obs.new_trace_id()
            groups.setdefault(want, []).append(
                RolloutRequest(uid=uid,
                               inputs=_host_array(spec.inputs),
                               x0=None if spec.x0 is None
                               else _host_array(spec.x0)))
        results: dict = {}
        dim = self.config.reservoir_dim
        arrival = time.perf_counter()
        for want, reqs in groups.items():
            for mb in bucketer.group(reqs):
                results.update(self._serve_microbatch(mb, want, dim, tids,
                                                      arrival))
        return results

    def _serve_microbatch(self, mb: MicroBatch, want: bool, dim: int,
                          tids: dict, arrival: float) -> dict:
        u = self._as_input(mb.inputs)
        b, t = u.shape[0], u.shape[1]
        x0b = (torch.zeros((b, dim), device=self.device) if mb.x0 is None
               else torch.as_tensor(mb.x0, device=self.device))
        t0 = time.perf_counter()
        out, _xf = self._dispatch(u, x0b, not want, False)
        self._record(b, t, t0, mb.real_steps)
        finish = time.perf_counter()
        seconds = finish - t0
        results = {}
        for j, req in enumerate(mb.requests):
            row = out[j, :req.length]
            tid = tids[req.uid]
            obs.span("request.serve", t0, finish, trace_id=tid,
                     clock="wall", batch=b, steps=t)
            obs.observe("request_latency_seconds", finish - arrival,
                        path="engine")
            results[req.uid] = RolloutResult(
                preds=None if want else row, states=row if want else None,
                timings=lifecycle_timings(
                    arrival_time=arrival, admit_time=t0, finish_time=finish,
                    seconds=seconds, trace_id=tid))
        return results

    def rollout(self, inputs, x0=None) -> torch.Tensor:
        """Roll the reservoir: (T, I) -> (T, R) or (B, T, I) -> (B, T, R)."""
        u, x0b, single = self._prepare(inputs, x0)
        b, t, _ = u.shape
        t0 = time.perf_counter()
        states, _ = self._dispatch(u, x0b, False, False)
        self._record(b, t, t0, None)
        return states[0] if single else states

    def predictions(self, inputs, x0=None) -> torch.Tensor:
        """Rollout + readout: (B, T, I) -> (B, T, O) predictions, the
        (B, T, R) state trajectory never materialized."""
        if self._w_out is None:
            raise ValueError("readout not trained; call fit_readout first "
                             "(or submit with want_states=True)")
        u, x0b, single = self._prepare(inputs, x0)
        b, t, _ = u.shape
        t0 = time.perf_counter()
        preds, _ = self._dispatch(u, x0b, True, False)
        self._record(b, t, t0, None)
        return preds[0] if single else preds


def _unspecialized_auto(device: torch.device) -> str:
    """What ``"auto"`` means without a schedule space (``specialize=
    False``): the kernels on a CUDA device, the PyTorch loop on the CPU
    (the JAX package's ``"xla"`` there)."""
    return "cuda" if device.type == "cuda" else "torch"


def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# -- bounded engine cache ----------------------------------------------------
# A long-lived multi-tenant server cycles through many reservoirs; an
# unbounded per-process cache of engines would grow without limit.  The
# cache is a module-level LRU with two key regimes:
#
# * registry identity ``((name, version), backend, device)`` — the
#   multi-tenant contract.  (name, version) is stable for the process's
#   lifetime, so a republished readout with value-equal tensors can NEVER
#   alias the old version's engine: the version number differs, and the
#   entry's staleness check still guards params/readout identity on top.
# * ``(id(params), backend, device)`` — the single-model accessor
#   (run_reservoir etc.).  A cached engine holds its params alive, so a
#   live entry's id can never be reused by a different object; after
#   eviction an id *can* recur, which the identity staleness check
#   catches before serving a wrong engine.
#
# Entries are (engine, kwargs-signature) tuples; per-tenant hit/miss
# counters land under ``engine_cache_stats()["tenants"]``.
ENGINE_CACHE_MAX = 32
_engine_cache: "collections.OrderedDict[tuple, tuple]" = \
    collections.OrderedDict()
_engine_cache_stats: dict = {"hits": 0, "misses": 0, "evictions": 0,
                             "tenants": {}}


def _tenant_counters(name) -> dict:
    return _engine_cache_stats["tenants"].setdefault(
        name, {"hits": 0, "misses": 0})


def engine_cache_stats(reset: bool = False) -> dict:
    """Hit/miss/eviction counters of the ``engine_for`` LRU (plus current
    size and the per-tenant breakdown); ``reset=True`` zeroes them."""
    out = dict(_engine_cache_stats, size=len(_engine_cache))
    out["tenants"] = {name: dict(c)
                      for name, c in _engine_cache_stats["tenants"].items()}
    if reset:
        _engine_cache_stats.update(hits=0, misses=0, evictions=0)
        _engine_cache_stats["tenants"].clear()
    return out


def engine_cache_clear() -> None:
    _engine_cache.clear()


def engine_cache_demote(tenant) -> int:
    """Move every cache entry of ``tenant`` — a registry ``(name,
    version)`` — to the eviction front of the LRU, so a just-retired model
    version is the first thing churn reclaims.  Returns the number of
    entries demoted (the engine stays usable until actually evicted:
    in-flight slots pinned to it finish unaffected)."""
    demoted = 0
    for key in list(_engine_cache):
        if key[0] == tenant:
            _engine_cache.move_to_end(key, last=False)
            demoted += 1
    return demoted


def _cache_put(key: tuple, eng: ReservoirEngine, sig: tuple) -> None:
    _engine_cache[key] = (eng, sig)
    _engine_cache.move_to_end(key)
    while len(_engine_cache) > ENGINE_CACHE_MAX:
        _engine_cache.popitem(last=False)
        _engine_cache_stats["evictions"] += 1
    _engine_cache_stats["misses"] += 1
    obs.event("engine_cache_miss", key=str(key))
    obs.inc("engine_cache_requests_total", outcome="miss")


def _params_stale(eng: ReservoirEngine, params: ESNParams) -> bool:
    cfg = params.config
    return (eng.params is not params
            or eng._w_out is not params.w_out
            or eng.params.w is not params.w
            or (eng.config.leak, eng.config.mode, eng.config.state_bits)
            != (cfg.leak, cfg.mode, cfg.state_bits))


def engine_for(params: ESNParams, backend: str = "auto", *, device=None,
               tenant=None, build=None, **kwargs) -> ReservoirEngine:
    """Engine accessor with a bounded LRU cache (reservoirs are frozen).

    Without ``tenant`` the key is ``(id(params), backend, device)`` — the
    ``run_reservoir`` fast path — and non-default kwargs bypass the cache.
    With ``tenant`` (a registry ``(name, version)`` tuple) the key is the
    *registry identity*: stable across republishes, so an equal-valued
    readout under a new version can never alias the retired engine, and
    hashable kwargs become part of the cached entry (a config change
    rebuilds).  ``build`` overrides the constructor
    (``build(params, backend=, device=, **kwargs) -> engine``).

    Every entry is invalidated by what the engine bakes in at construction
    — the reservoir matrix, the *readout* (so a stale engine is never
    served after ``fit_readout`` replaces ``w_out``), and the
    leak/mode/precision config.  At most :data:`ENGINE_CACHE_MAX` engines
    stay resident (least recently used evicted first);
    ``engine_cache_stats()`` exposes the hit/miss/eviction counters,
    globally and per tenant.  ``backend="auto"`` keys the cache on the
    backend the plan autotuner resolves for these params on this device —
    the same resolution the constructor runs, so the key and the built
    engine's backend always agree.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"not {backend!r}")
    dev = resolve_device(params.device if device is None else device)
    if backend != "auto":
        bk = backend
    elif kwargs.get("schedule") is not None:
        sched = kwargs["schedule"]
        bk = getattr(sched, "schedule", sched).backend
    elif not kwargs.get("specialize", True):
        bk = _unspecialized_auto(dev)   # no schedule space to tune
    else:
        bk = resolve_backend(params, backend, device=dev)
    if tenant is None:
        key = (id(params), bk, str(dev))
        ent = _engine_cache.get(key)
        eng = ent[0] if ent is not None else None
        if eng is None or kwargs or _params_stale(eng, params):
            eng = (build or ReservoirEngine)(params, backend=backend,
                                            device=dev, **kwargs)
            if not kwargs and build is None:
                _cache_put(key, eng, ())
        else:
            _engine_cache.move_to_end(key)
            _engine_cache_stats["hits"] += 1
            obs.inc("engine_cache_requests_total", outcome="hit")
        return eng

    name = tenant[0] if isinstance(tenant, tuple) else tenant
    counters = _tenant_counters(name)
    try:
        sig = tuple(sorted(kwargs.items()))
        hash(sig)
    except TypeError as e:
        raise TypeError(
            "engine_for(tenant=...) caches on the kwargs signature, so "
            f"every kwarg must be hashable: {kwargs}") from e
    key = (tenant, bk, str(dev))
    ent = _engine_cache.get(key)
    if (ent is not None and ent[1] == sig
            and not _params_stale(ent[0], params)):
        _engine_cache.move_to_end(key)
        _engine_cache_stats["hits"] += 1
        counters["hits"] += 1
        obs.inc("engine_cache_requests_total", outcome="hit", tenant=name)
        return ent[0]
    if build is not None:
        eng = build(params, backend=backend, device=dev, **kwargs)
    else:
        eng = ReservoirEngine(params, backend=backend, tenant=name,
                              device=dev, **kwargs)
    _cache_put(key, eng, sig)
    counters["misses"] += 1
    return eng


__all__ = ["BACKENDS", "DENSE_DISPATCH_DENSITY", "ENGINE_CACHE_MAX",
           "ReservoirEngine", "engine_for", "engine_cache_clear",
           "engine_cache_demote", "engine_cache_stats"]
