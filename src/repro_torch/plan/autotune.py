"""Measured-cost plan autotuning: close the loop on the cost model.

The specialization pass picks its schedule — band budget, shift-add
crossover, batch tile — from fixed heuristics, and ``backend="auto"``
has two real backends to choose between on the card: ``cuda`` (one
launch of the B2 rollout kernel per call) and ``torch`` (the per-step
PyTorch loop).  The paper's contribution is an *extensible cost model
driving the implementation*: predicted cost picks the design point,
measurement calibrates the predictor.  This module is that loop for the
rollout schedule space:

  predict  — enumerate every valid candidate schedule (budgets x
             crossovers x batch tiles x backends) and price each one with
             the calibrated linear model in
             :mod:`repro_torch.core.costmodel`, using counts-only
             ``specialize_summary`` analysis — no tile data, no launch.
  prune    — keep the top-K predicted schedules (the default-heuristic
             schedule is ALWAYS kept, so the measured winner can never
             lose to the default on the tuner's own trials).
  measure  — build real engines on the device and time the actual
             rollout, best-of-reps, each ending in a device sync.
  cache    — the winner lands on the plan (``plan.describe()`` reports
             it), in the process-wide :class:`ScheduleCache`, and — via
             ``autotune_cache_save`` — in a JSON file keyed on plan
             fingerprint + hardware fingerprint, so serve startup after
             ``autotune_cache_load`` pays zero re-tuning.

The ``cuda`` backend's candidates differ from the ``torch`` backend's in
three ways.  Its kernel takes at most 16 batch rows per tile, so a tile of
32 is infeasible and dropped; it repacks every band into per-block
shares whatever the budget, so its budget axis collapses to the default;
and crossovers that fold the same planes keep one name.  No trial times
one launch under several names.  Under the card's prior a cold cache
serves the default ``cuda`` schedule without pricing the others (see
:func:`resolve_schedule`).

Every candidate schedule gives the same results as every other (int8
accumulates in exact int32, fp32 keeps ascending-row order), so tuning is
purely a throughput decision and never changes served results.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import costmodel
from repro_torch.device import resolve_device
from repro_torch.plan.plan import DEFAULT_VMEM_BUDGET, ExecutionPlan
from repro_torch.plan.specialize import (DEFAULT_BATCH_TILE,
                                         default_crossover,
                                         specialize_summary)

__all__ = [
    "BACKENDS",
    "Schedule",
    "TunedSchedule",
    "ScheduleCache",
    "default_schedule",
    "candidate_schedules",
    "predict_cost",
    "set_cost_model",
    "plan_fingerprint",
    "hardware_fingerprint",
    "resolve_schedule",
    "resolve_backend",
    "autotune_rollout",
    "autotune_cache",
    "autotune_cache_load",
    "autotune_cache_save",
]

BACKENDS = ("torch", "cuda")

# Default tuning shape: small enough to measure in milliseconds, big
# enough that the backend choice it makes transfers to serve-sized
# batches (the cache key buckets the batch axis, so other shapes re-tune).
TUNE_BATCH = 8
TUNE_STEPS = 8


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One point in the rollout schedule space.

    The regime (resident vs pipelined) is not a free axis: it falls out of
    ``vmem_budget`` deterministically (``None`` forces resident; a finite
    budget pipelines iff the folded tiles overflow it), so enumerating
    budgets enumerates regimes.
    """

    mode: str                  # "fp32" | "int8" (kernel mode)
    backend: str               # "torch" | "cuda"
    vmem_budget: int | None
    crossover: int
    batch_tile_max: int

    def key(self) -> tuple:
        return (self.mode, self.backend, self.vmem_budget, self.crossover,
                self.batch_tile_max)

    def sort_key(self) -> tuple:
        """Total order for deterministic tie-breaking (``None`` budget —
        forced resident — sorts as -1, below every finite budget)."""
        return (self.mode, self.backend,
                -1 if self.vmem_budget is None else self.vmem_budget,
                self.crossover, self.batch_tile_max)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Schedule":
        return cls(mode=d["mode"], backend=d["backend"],
                   vmem_budget=d["vmem_budget"],
                   crossover=int(d["crossover"]),
                   batch_tile_max=int(d["batch_tile_max"]))

    def describe(self) -> str:
        budget = "none" if self.vmem_budget is None else str(self.vmem_budget)
        return (f"{self.backend} budget={budget} "
                f"crossover={self.crossover} tile={self.batch_tile_max}")


def default_schedule(plan: ExecutionPlan, mode: str,
                     backend: str = "torch") -> Schedule:
    """The fixed-heuristic schedule — the tuner's reference point and
    the fallback when tuning is disabled or impossible."""
    return Schedule(mode=mode, backend=backend,
                    vmem_budget=DEFAULT_VMEM_BUDGET,
                    crossover=default_crossover(plan.block),
                    batch_tile_max=DEFAULT_BATCH_TILE)


@dataclasses.dataclass(frozen=True)
class TunedSchedule:
    """A tuning decision: the chosen schedule plus the evidence for it.

    ``source`` is ``"measured"`` (full predict -> prune -> measure loop),
    ``"predicted"`` (analytic model only — what engine construction does
    on a cache miss, so startup never blocks on measurement), or
    ``"cache"`` (replayed from the persisted JSON cache).  ``trials``
    records every measured candidate as ``(schedule_dict, predicted_s,
    measured_s)`` — the calibration rows ``fit_rollout_cost`` consumes.
    """

    schedule: Schedule
    batch: int
    steps: int
    predicted_s: float
    measured_s: float | None = None
    default_predicted_s: float | None = None
    default_measured_s: float | None = None
    source: str = "predicted"
    n_candidates: int = 0
    trials: tuple = ()

    def as_dict(self) -> dict:
        return {
            "schedule": self.schedule.as_dict(),
            "batch": self.batch, "steps": self.steps,
            "predicted_s": self.predicted_s,
            "measured_s": self.measured_s,
            "default_predicted_s": self.default_predicted_s,
            "default_measured_s": self.default_measured_s,
            "source": self.source, "n_candidates": self.n_candidates,
            "trials": [{"schedule": s, "predicted_s": p, "measured_s": m}
                       for s, p, m in self.trials],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TunedSchedule":
        return cls(
            schedule=Schedule.from_dict(d["schedule"]),
            batch=int(d["batch"]), steps=int(d["steps"]),
            predicted_s=float(d["predicted_s"]),
            measured_s=d.get("measured_s"),
            default_predicted_s=d.get("default_predicted_s"),
            default_measured_s=d.get("default_measured_s"),
            source=d.get("source", "cache"),
            n_candidates=int(d.get("n_candidates", 0)),
            trials=tuple((t["schedule"], t["predicted_s"], t["measured_s"])
                         for t in d.get("trials", ())))

    def describe(self) -> str:
        meas = (f"{self.measured_s * 1e3:.3f} ms measured"
                if self.measured_s is not None else "predict-only")
        return (f"{self.schedule.describe()} "
                f"({self.predicted_s * 1e3:.3f} ms predicted, {meas}, "
                f"{self.source} over {self.n_candidates} candidates)")


# -- fingerprints ------------------------------------------------------------
def plan_fingerprint(plan: ExecutionPlan) -> str:
    """Stable digest of the structure the schedule space depends on.

    Two matrices with the same block sparsity pattern, digit mode and
    set-digit count have identical schedule spaces and near-identical
    costs, so they share a cache entry — a registry republishing a
    same-shaped matrix reuses the tuning.  Uses ``fm.ones`` (already
    computed at matrix compile) rather than ``plan.stats`` so fp32-only
    consumers never pay for the integer lowering just to be fingerprinted.
    """
    h = hashlib.sha1()
    for part in (plan.shape, plan.block, plan.mode, plan.weight_bits,
                 plan.blocks_nnz, plan._fm.ones):
        h.update(repr(part).encode())
    h.update(np.ascontiguousarray(plan.block_rows).tobytes())
    h.update(np.ascontiguousarray(plan.block_cols).tobytes())
    return h.hexdigest()[:16]


def hardware_fingerprint(device=None) -> str:
    """Device identity the measurements are valid for — a persisted cache
    recorded on one machine never silently serves another.  ``device`` is
    the one the engine runs on (default: the current CUDA device):
    ``cuda:<card name>x<card count>`` or ``cpu:cpux1``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu:cpux1"
    name = torch.cuda.get_device_name(dev).replace(" ", "_")
    return f"cuda:{name}x{torch.cuda.device_count()}"


def _batch_bucket(batch: int) -> int:
    """Round the batch up to a power of two: one cache entry per regime of
    batch sizes, not per exact batch."""
    return 1 << max(0, int(batch) - 1).bit_length()


# -- candidate enumeration + prediction --------------------------------------
def candidate_schedules(plan: ExecutionPlan, mode: str,
                        backends=BACKENDS) -> list:
    """Every *valid* schedule in the search grid.

    Budgets sweep the regime axis (``None`` = forced resident, then
    halvings of the default that push big matrices into pipelined bands);
    crossovers sweep the matmul/shift-add split (int8 only — fp32 has no
    digit planes to strength-reduce, so its crossover is pinned to the
    default and the axis collapses); batch tiles sweep grid parallelism.
    Candidates whose band packing is infeasible (a single column's folded
    tiles overflow half the budget — ``specialize_rollout`` would raise)
    are dropped here, so everything returned can actually build.  The
    ``cuda`` backend keeps one budget (its kernel ignores the regime), no
    tile above its kernel's one MMA tile of rows (it would raise), and one
    crossover of each set that folds the same planes (they build one
    launch): the default crossover where it is in the set, else the
    lowest.
    """
    # deferred: the kernel package imports plan
    from repro_torch.kernels.reservoir_rollout.reservoir_rollout import \
        _MMA_ROWS
    block = plan.block
    budgets = [None, DEFAULT_VMEM_BUDGET, DEFAULT_VMEM_BUDGET // 2,
               DEFAULT_VMEM_BUDGET // 4]
    if mode == "fp32":
        crossovers = [default_crossover(block)]
    else:
        crossovers = sorted({0, block // 4, default_crossover(block),
                             block, 2 * block})
    tiles = sorted({8, DEFAULT_BATCH_TILE, 32})
    out, seen, built = [], set(), {}
    for backend in backends:
        b_budgets = [DEFAULT_VMEM_BUDGET] if backend == "cuda" else budgets
        b_tiles = [t for t in tiles
                   if backend != "cuda" or t <= _MMA_ROWS]
        for budget in b_budgets:
            for crossover in crossovers:
                for tile in b_tiles:
                    try:
                        summary = specialize_summary(
                            plan, mode, vmem_budget=budget,
                            crossover=crossover, batch_tile_max=tile)
                    except ValueError:
                        continue  # infeasible double-buffer packing
                    s = Schedule(mode, backend, budget, crossover, tile)
                    if s.key() in seen:
                        continue
                    seen.add(s.key())
                    if backend == "cuda":
                        # the crossover is a threshold, so equal counts
                        # mean the same folded planes: the same launch
                        what = (tile, summary["n_matmul_terms"],
                                summary["shiftadd_digits"])
                        if what in built:
                            if crossover == default_crossover(block):
                                out[built[what]] = s
                            continue
                        built[what] = len(out)
                    out.append(s)
    return out


def predict_cost(plan: ExecutionPlan, schedule: Schedule, batch: int,
                 steps: int,
                 model: costmodel.RolloutCostModel | None = None, *,
                 device=None) -> float:
    """Analytic seconds for one rollout under ``schedule`` — counts-only
    summary in, calibrated linear model out.  Launches nothing.  Without
    ``model`` the prior (or installed model) of ``device``'s type prices
    it."""
    if model is None:
        model = _default_model(device)
    summary = specialize_summary(
        plan, schedule.mode, vmem_budget=schedule.vmem_budget,
        crossover=schedule.crossover,
        batch_tile_max=schedule.batch_tile_max)
    feats = costmodel.rollout_cost_features(summary, plan.block, batch,
                                            steps)
    return model.predict(schedule.backend, feats)


_MODEL_CACHE: dict = {}


def _default_model(device=None) -> costmodel.RolloutCostModel:
    """The model of ``device``'s type: a CPU engine prices with the CPU
    prior on a machine that has a card too."""
    platform = resolve_device(device).type
    model = _MODEL_CACHE.get(platform)
    if model is None:
        model = _MODEL_CACHE[platform] = \
            costmodel.default_rollout_cost_model(platform)
    return model


def set_cost_model(model: costmodel.RolloutCostModel) -> None:
    """Install a calibrated model as the default predictor of its
    platform (e.g. one refit from measured trials)."""
    _MODEL_CACHE[model.platform] = model


# -- measurement -------------------------------------------------------------
def _probe_params(plan: ExecutionPlan, mode: str, device):
    """Synthetic ESNParams over the plan's own matrix, for measuring when
    the caller has no trained params at hand (the matrix is what matters;
    w_in only sets the projection product's inner dim)."""
    from repro_torch.core.esn import ESNConfig, ESNParams
    fm = plan._fm
    dim = plan.shape[0]
    digit = fm.mode if fm.mode in ("pn", "csd") else "csd"
    esn_mode = f"int8-{digit}" if mode == "int8" else "fp32"
    cfg = ESNConfig(reservoir_dim=dim, input_dim=4, mode=esn_mode)
    rng = np.random.default_rng(0)
    w_in = torch.as_tensor(rng.standard_normal((4, dim)) * 0.1,
                           dtype=torch.float32, device=device)
    return ESNParams(w=fm, w_in=w_in, w_out=None, config=cfg)


def _measure_schedule(plan: ExecutionPlan, schedule: Schedule, params,
                      batch: int, steps: int, reps: int = 2,
                      device=None) -> float:
    """Wall-clock one candidate through the real engine path on
    ``device``: best-of-reps on the host clock around a rollout that ends
    in a device sync.  One warm-up call runs outside the clock (on the
    card it builds the CUDA library at first use and packs and copies the
    grid's shares).  A failed launch raises."""
    # deferred: serve imports plan
    from repro_torch.serve.engine import ReservoirEngine

    dev = resolve_device(device)
    eng = ReservoirEngine(
        params, backend=schedule.backend,
        vmem_budget=schedule.vmem_budget, crossover=schedule.crossover,
        batch_tile_max=schedule.batch_tile_max, specialize=True, device=dev)
    rng = np.random.default_rng(1)
    u = torch.as_tensor(rng.standard_normal(
        (batch, steps, params.config.input_dim)), dtype=torch.float32,
        device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    eng.rollout(u)                          # set-up outside the clock
    sync()
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        eng.rollout(u)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


# -- persisted schedule cache ------------------------------------------------
class ScheduleCache:
    """``(plan fingerprint, mode, batch bucket, hardware) -> TunedSchedule``
    with JSON persistence, so a serve process can load the winners a
    tuning run measured and never re-tune at startup.

    The files have a version of their own: the JAX package's cache files
    (version 1, backends ``xla``/``pallas``) are refused, never replayed.
    """

    VERSION = 2

    def __init__(self):
        self._entries: dict = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def entry_key(fingerprint: str, mode: str, batch: int,
                  hardware: str) -> str:
        return f"{fingerprint}|{mode}|b{_batch_bucket(batch)}|{hardware}"

    def get(self, key: str):
        tuned = self._entries.get(key)
        if tuned is None:
            self.misses += 1
        else:
            self.hits += 1
        return tuned

    def put(self, key: str, tuned: TunedSchedule) -> None:
        self._entries[key] = tuned

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self.hits = self.misses = 0

    def stats(self) -> dict:
        return {"size": len(self._entries), "hits": self.hits,
                "misses": self.misses}

    def as_dict(self) -> dict:
        return {"version": self.VERSION,
                "entries": {k: t.as_dict()
                            for k, t in sorted(self._entries.items())}}

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1, sort_keys=True)

    def load(self, path, merge: bool = True) -> int:
        """Merge (or replace) entries from ``path``; returns the number of
        entries loaded.  Entries replay as ``source="cache"``.  Raises
        ``ValueError`` on another version or a backend not in
        :data:`BACKENDS`, and then loads nothing."""
        with open(path) as f:
            data = json.load(f)
        if data.get("version") != self.VERSION:
            raise ValueError(
                f"schedule cache version {data.get('version')} != "
                f"{self.VERSION} (version 1 is the JAX package's, with "
                "backends xla/pallas): re-tune rather than trust entries "
                "this package did not measure")
        loaded = {}
        for key, d in data.get("entries", {}).items():
            tuned = TunedSchedule.from_dict(d)
            if tuned.schedule.backend not in BACKENDS:
                raise ValueError(
                    f"schedule cache entry {key!r} has backend "
                    f"{tuned.schedule.backend!r}, not one of {BACKENDS}")
            loaded[key] = dataclasses.replace(tuned, source="cache")
        if not merge:
            self._entries.clear()
        self._entries.update(loaded)
        return len(loaded)


_CACHE = ScheduleCache()


def autotune_cache() -> ScheduleCache:
    """The process-wide tuning cache (engine construction resolves
    through it)."""
    return _CACHE


def autotune_cache_save(path) -> None:
    _CACHE.save(path)


def autotune_cache_load(path, merge: bool = True) -> int:
    return _CACHE.load(path, merge=merge)


# -- resolution: the one entry point engines call ----------------------------
def resolve_schedule(plan: ExecutionPlan, mode: str, *,
                     backend: str = "auto", batch: int = TUNE_BATCH,
                     steps: int = TUNE_STEPS, measure: bool = False,
                     params=None, top_k: int = 3, reps: int = 2,
                     model: costmodel.RolloutCostModel | None = None,
                     cache: ScheduleCache | None = None,
                     refresh: bool = False, device=None) -> TunedSchedule:
    """The tuner's front door: cache -> predict [-> prune -> measure].

    ``measure=False`` (engine construction) never launches or times
    anything: a cache hit replays the persisted winner, a miss falls back
    to the analytic model's pick, which under the card's prior is the
    default ``cuda`` schedule.  ``measure=True`` (explicit
    ``autotune_rollout``) runs the full loop on ``device`` and caches the
    measured winner, which subsequent engine constructions then inherit.
    An explicit ``backend`` restricts the search to that backend.
    ``device`` (default: the current CUDA device) picks the hardware key
    and, without ``model``, the prior.
    """
    if mode not in ("fp32", "int8"):
        raise ValueError(f"mode must be fp32 or int8, not {mode!r}")
    dev = resolve_device(device)
    cache = _CACHE if cache is None else cache
    backends = BACKENDS if backend == "auto" else (backend,)
    hw = hardware_fingerprint(dev)
    key = "|".join((ScheduleCache.entry_key(
        plan_fingerprint(plan), mode, batch, hw),) + backends)
    if not refresh:
        tuned = cache.get(key)
        if tuned is not None and (tuned.source == "measured"
                                  or tuned.measured_s is not None
                                  or not measure):
            _pin_to_plan(plan, mode, batch, hw, tuned)
            obs.event("schedule_resolve", source=tuned.source, mode=mode,
                      schedule=tuned.schedule.describe())
            obs.inc("schedule_cache_requests_total", outcome="hit")
            return tuned
    model = _default_model(dev) if model is None else model
    if not measure and model.platform == "cuda":
        # the card's prior was fitted on trials whose budgets built one
        # launch and whose crossovers the host clock could not tell apart
        best = default_schedule(plan, mode, "cuda" if "cuda" in backends
                                else backends[0])
        pred = predict_cost(plan, best, batch, steps, model)
        tuned = TunedSchedule(
            schedule=best, batch=batch, steps=steps, predicted_s=pred,
            default_predicted_s=pred, source="predicted", n_candidates=1)
        return _resolved(cache, key, plan, mode, batch, hw, tuned)
    cands = candidate_schedules(plan, mode, backends)
    if not cands:
        cands = [default_schedule(plan, mode, backends[0])]
    scored = sorted(
        ((predict_cost(plan, s, batch, steps, model), s) for s in cands),
        key=lambda t: (t[0], t[1].sort_key()))
    default = default_schedule(plan, mode,
                               "torch" if "torch" in backends
                               else backends[0])
    default_pred = predict_cost(plan, default, batch, steps, model)

    if not measure:
        pred, best = scored[0]
        tuned = TunedSchedule(
            schedule=best, batch=batch, steps=steps, predicted_s=pred,
            default_predicted_s=default_pred, source="predicted",
            n_candidates=len(cands))
    else:
        if params is None:
            params = _probe_params(plan, mode, dev)
        chosen = scored[:max(1, top_k)]
        if not any(s.key() == default.key() for _p, s in chosen):
            chosen.append((default_pred, default))
        trials = []
        for pred, s in chosen:
            t0 = time.perf_counter()
            meas = _measure_schedule(plan, s, params, batch, steps, reps,
                                     dev)
            obs.span("autotune.trial", t0, time.perf_counter(),
                     clock="wall", schedule=s.describe(),
                     predicted_s=pred, measured_s=meas)
            trials.append((s, pred, meas))
        win_sched, win_pred, win_meas = min(
            trials, key=lambda t: (t[2], t[0].sort_key()))
        default_meas = next(m for s, _p, m in trials
                            if s.key() == default.key())
        tuned = TunedSchedule(
            schedule=win_sched, batch=batch, steps=steps,
            predicted_s=win_pred, measured_s=win_meas,
            default_predicted_s=default_pred,
            default_measured_s=default_meas, source="measured",
            n_candidates=len(cands),
            trials=tuple((s.as_dict(), p, m) for s, p, m in trials))
    return _resolved(cache, key, plan, mode, batch, hw, tuned)


def _resolved(cache: ScheduleCache, key: str, plan: ExecutionPlan,
              mode: str, batch: int, hw: str,
              tuned: TunedSchedule) -> TunedSchedule:
    """Cache and pin a fresh decision, and record the miss."""
    cache.put(key, tuned)
    _pin_to_plan(plan, mode, batch, hw, tuned)
    obs.event("schedule_resolve", source=tuned.source, mode=mode,
              schedule=tuned.schedule.describe())
    obs.inc("schedule_cache_requests_total", outcome="miss")
    return tuned


def _pin_to_plan(plan: ExecutionPlan, mode: str, batch: int, hw: str,
                 tuned: TunedSchedule) -> None:
    pinned = getattr(plan, "_tuned", None)
    if pinned is None:
        pinned = plan._tuned = {}
    pinned[(mode, _batch_bucket(batch), hw)] = tuned


def autotune_rollout(plan: ExecutionPlan, mode: str, *,
                     batch: int = TUNE_BATCH, steps: int = TUNE_STEPS,
                     params=None, backends=BACKENDS, top_k: int = 3,
                     reps: int = 2,
                     model: costmodel.RolloutCostModel | None = None,
                     cache: ScheduleCache | None = None,
                     refresh: bool = False, device=None) -> TunedSchedule:
    """Run the full predict -> prune -> measure -> cache loop for one plan
    on ``device``.

    The measured winner can never lose to the default-heuristic schedule
    on its own trials: the default is always among the measured candidates
    and the winner is the measured argmin.
    """
    backend = "auto" if tuple(backends) == BACKENDS else backends[0]
    return resolve_schedule(
        plan, mode, backend=backend, batch=batch, steps=steps,
        measure=True, params=params, top_k=top_k, reps=reps, model=model,
        cache=cache, refresh=refresh, device=device)


def resolve_backend(params, backend: str = "auto",
                    batch: int = TUNE_BATCH, *, device=None) -> str:
    """The backend ``backend="auto"`` resolves to for these params on
    ``device`` (default: the params' device) — the one function
    ``engine_for``'s cache key AND ``ReservoirEngine``'s constructor both
    route through, so they can never disagree."""
    if backend != "auto":
        return backend
    from repro_torch.plan.plan import plan_for
    plan = plan_for(params.w)
    mode = "int8" if params.config.mode.startswith("int8") else "fp32"
    dev = params.device if device is None else device
    return resolve_schedule(plan, mode, batch=batch,
                            device=dev).schedule.backend
