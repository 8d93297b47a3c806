"""Batched reservoir-rollout engine — the serving face of the paper.

The paper's win is specializing the *recurrent* multiply of a frozen
reservoir; serving-side, the unit of work is therefore the whole rollout
``x(n) = f(W_in u(n) + W x(n-1))`` over a request batch, not a single gemv.
The engine builds from the one shared :class:`repro_torch.plan.ExecutionPlan`
lowering of the reservoir matrix and fronts the CUDA rollout kernels:

* ``specialize=True`` (default) — :class:`SpecializedRollout`, the
  plan-specialized kernel (folded int8 tiles + shift-add digits);
* ``specialize=False`` — :class:`FusedRollout`, the generic banded kernel
  every specialized schedule is held bit-identical to.

On a CPU device both run their plain PyTorch twins.  With a trained
readout the engine serves *predictions*: the readout kernel applies
``W_out`` after each step, so the state trajectory is never materialized on
the prediction path.  The request/response surface is the
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
from repro_torch.device import resolve_device
from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
from repro_torch.kernels.reservoir_rollout.specialized import \
    SpecializedRollout
from repro_torch.plan import DEFAULT_BATCH_TILE, DEFAULT_VMEM_BUDGET, plan_for
from repro_torch.serve.api import (RolloutResult, SubmitSpec,
                                   lifecycle_timings)
from repro_torch.serve.batching import (MicroBatch, PaddingBucketer,
                                        RolloutRequest)
from repro_torch.serve.stats import ServeStats

# one process-wide warning for deadline-bearing specs on the one-shot
# path (the result still records timings["deadline_ignored"] every time)
_WARNED_DEADLINE = False

# the only backend until a second one (a torch scan) is ported
BACKENDS = ("auto",)


class ReservoirEngine:
    """Batched rollout (and readout) for one frozen ESN on one device.

    ``backend="auto"`` resolves to the kernel backend, reported as
    ``"cuda"`` (the autotuner that chooses between backends is not ported
    yet).
    ``device`` defaults to the params' device.
    """

    def __init__(self, params: ESNParams, *, backend: str = "auto",
                 stats: ServeStats | None = None,
                 vmem_budget: int | None = DEFAULT_VMEM_BUDGET,
                 specialize: bool = True, crossover: int | None = None,
                 batch_tile_max: int | None = None, device=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"not {backend!r}")
        self.params = params
        self.config = params.config
        self.device = resolve_device(params.device if device is None
                                     else device)
        self.stats = stats if stats is not None else ServeStats()
        self.plan = plan_for(params.w)
        self.specialize = specialize
        self._int8 = self.config.mode.startswith("int8")
        self.backend = "cuda"
        # readout captured at construction; engine_for invalidates the
        # cached engine when params.w_out is replaced (fit_readout)
        self._w_out = params.w_out
        obs.event("engine_build", backend=self.backend,
                  device=str(self.device), specialize=specialize)
        obs.inc("engine_builds_total", backend=self.backend)
        kw = {}
        if specialize:
            kw = {"crossover": crossover,
                  "batch_tile_max": batch_tile_max or DEFAULT_BATCH_TILE}
        cls = SpecializedRollout if specialize else FusedRollout
        self._fused = cls(
            self.plan, params.w_in, leak=self.config.leak,
            mode="int8" if self._int8 else "fp32",
            state_bits=self.config.state_bits, w_out=self._w_out,
            vmem_budget=vmem_budget, device=self.device, **kw)

    @property
    def program(self):
        """The :class:`~repro_torch.plan.RolloutProgram` behind
        ``specialize=True`` (None with ``specialize=False``)."""
        return getattr(self._fused, "program", None)

    @property
    def has_readout(self) -> bool:
        """Whether a trained ``W_out`` is baked into this engine (serving
        defaults to predictions when True, states otherwise)."""
        return self._w_out is not None

    # -- backend dispatch ----------------------------------------------------
    def _dispatch(self, u, x0b, with_readout: bool, with_final: bool,
                  donate: bool = False):
        """One rollout call ``(B, T, I), (B, R) -> (out, final_or_None)``.

        ``out`` is (B, T, O) predictions or (B, T, R) states, a transposed
        view of the kernel's (T, B, *) output.  ``donate`` writes the
        final state into ``x0b`` in place."""
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
        if not defer:
            self._sync()
        seconds = time.perf_counter() - t0
        self.stats.record_call(batch=batch, steps=steps, seconds=seconds,
                               real_steps=real_steps, deferred=defer)
        obs.span("engine.dispatch" if defer else "engine.rollout",
                 t0, t0 + seconds, backend=self.backend, batch=batch,
                 steps=steps, deferred=defer)
        obs.observe("engine_rollout_seconds", seconds, backend=self.backend)

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
        resumes from bit-identically.  ``donate_state=True`` has the
        kernel write x_end into the caller's ``x0`` buffer in place (and
        return it), and ``defer_sync=True`` skips the per-call device sync
        so the serve loop only waits for the device at slot retirement.
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
        ``timings["deadline_ignored"] = True``.
        """
        _reject_model(spec)
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
        u, x0b, single = self._prepare(spec.inputs, spec.x0)
        b, t, _ = u.shape
        trace_id = spec.trace_id or obs.new_trace_id()
        t0 = time.perf_counter()
        out, xf = self._dispatch(u, x0b, not want, True)
        self._record(b, t, t0, None)
        finish = time.perf_counter()
        obs.span("request.serve", t0, finish, trace_id=trace_id,
                 clock="wall", batch=b, steps=t)
        obs.observe("request_latency_seconds", finish - t0, path="engine")
        if single:
            out, xf = out[0], xf[0]
        timings = lifecycle_timings(arrival_time=t0, admit_time=t0,
                                    finish_time=finish, seconds=finish - t0,
                                    trace_id=trace_id)
        if deadline_ignored:
            timings["deadline_ignored"] = True
        return RolloutResult(preds=None if want else out,
                             states=out if want else None,
                             final_state=xf, timings=timings)

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
            _reject_model(spec)
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


def _reject_model(spec: SubmitSpec) -> None:
    if spec.model is not None:
        raise ValueError(
            f"spec routes to model {spec.model!r}, but model routing "
            "(the registry) is not ported yet; this is a single-model "
            "engine")


def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# -- bounded engine cache ----------------------------------------------------
# A long-lived server cycles through many reservoirs; an unbounded
# per-process cache of engines would grow without limit.  The cache is a
# module-level LRU keyed on ``(id(params), backend, device)``.  A cached
# engine holds its params alive, so a live entry's id can never be reused
# by a different object; after eviction an id *can* recur, which the
# identity staleness check catches before serving a wrong engine.
ENGINE_CACHE_MAX = 32
_engine_cache: "collections.OrderedDict[tuple, ReservoirEngine]" = \
    collections.OrderedDict()
_engine_cache_stats: dict = {"hits": 0, "misses": 0, "evictions": 0}


def engine_cache_stats(reset: bool = False) -> dict:
    """Hit/miss/eviction counters of the ``engine_for`` LRU (plus its
    current size); ``reset=True`` zeroes them."""
    out = dict(_engine_cache_stats, size=len(_engine_cache))
    if reset:
        _engine_cache_stats.update(hits=0, misses=0, evictions=0)
    return out


def engine_cache_clear() -> None:
    _engine_cache.clear()


def _params_stale(eng: ReservoirEngine, params: ESNParams) -> bool:
    cfg = params.config
    return (eng.params is not params
            or eng._w_out is not params.w_out
            or eng.params.w is not params.w
            or (eng.config.leak, eng.config.mode, eng.config.state_bits)
            != (cfg.leak, cfg.mode, cfg.state_bits))


def engine_for(params: ESNParams, backend: str = "auto", *, device=None,
               **kwargs) -> ReservoirEngine:
    """Engine accessor with a bounded LRU cache (reservoirs are frozen).

    Keyed on ``(id(params), backend, device)``; non-default kwargs bypass
    the cache.  Every entry is invalidated by what the engine bakes in at
    construction — the reservoir matrix, the *readout* (so a stale engine
    is never served after ``fit_readout`` replaces ``w_out``), and the
    leak/mode/precision config.  At most :data:`ENGINE_CACHE_MAX` engines
    stay resident (least recently used evicted first).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"not {backend!r}")
    dev = resolve_device(params.device if device is None else device)
    key = (id(params), "cuda", str(dev))
    eng = _engine_cache.get(key)
    if eng is None or kwargs or _params_stale(eng, params):
        eng = ReservoirEngine(params, backend=backend, device=dev, **kwargs)
        if not kwargs:
            _engine_cache[key] = eng
            _engine_cache.move_to_end(key)
            while len(_engine_cache) > ENGINE_CACHE_MAX:
                _engine_cache.popitem(last=False)
                _engine_cache_stats["evictions"] += 1
            _engine_cache_stats["misses"] += 1
            obs.event("engine_cache_miss", key=str(key))
            obs.inc("engine_cache_requests_total", outcome="miss")
    else:
        _engine_cache.move_to_end(key)
        _engine_cache_stats["hits"] += 1
        obs.inc("engine_cache_requests_total", outcome="hit")
    return eng


__all__ = ["BACKENDS", "ENGINE_CACHE_MAX", "ReservoirEngine", "engine_for",
           "engine_cache_clear", "engine_cache_stats"]
