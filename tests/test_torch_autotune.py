"""The port's plan autotuner against the JAX package's.

Modelled on ``tests/test_autotune.py``.  The same seeded weights (carried
with ``params_from_numpy``) go through both packages' tuners on the CPU,
where the port's backends are ``torch`` (the reference's ``xla``) and
``cuda`` (the kernels' plain twins, the reference's interpret-mode
``pallas``):

* the plan fingerprint and the artefacts it digests are identical;
* the ``torch`` candidates are the reference's ``xla`` ones renamed, each
  priced the same (relative ``PRED_RTOL``); the ``cuda`` candidates have
  one budget, no batch tile above 16 and one name per launch;
* a cold, predict-only resolution picks the reference's schedule renamed
  at the same predicted seconds, and ``resolve_backend`` gives ``torch``
  wherever the reference gives ``xla``; under the card's prior it serves
  the default ``cuda`` schedule and enumerates no candidate;
* a measured tuning keeps the default among its trials, its winner no
  worse than it, and the winner's engine serves the default's bits
  (int8, batch >= 2: C-ref-1, C-port-1);
* the schedule cache replays what it saved, refuses the reference's cache
  files, and counts hits and misses as the reference's does;
* ``"auto"`` engines resolve through the tuner, explicit knobs win and
  ``schedule=`` bypasses resolution.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import esn as jesn
from repro.plan import autotune as jat
from repro.plan import plan_for as j_plan_for
from repro.serve import ReservoirEngine as JEngine
from repro_torch import obs
from repro_torch.core import costmodel as tcm
from repro_torch.core import esn as tesn
from repro_torch.core.sparse import FixedMatrix, random_sparse_matrix
from repro_torch.plan import autotune as tat
from repro_torch.plan import plan_for, specialize_summary
from repro_torch.plan.autotune import (BACKENDS, Schedule, ScheduleCache,
                                       TunedSchedule, autotune_rollout,
                                       candidate_schedules, default_schedule,
                                       hardware_fingerprint, plan_fingerprint,
                                       predict_cost, resolve_backend,
                                       resolve_schedule)
from repro_torch.serve import (ReservoirEngine, engine_cache_clear,
                               engine_cache_stats, engine_for)


@pytest.fixture(scope="module", autouse=True)
def _release_xla_executables():
    """Free the XLA executables this module's reference calls compiled once
    its tests in this worker are done: each holds JIT memory mappings, and
    a test worker that keeps every module's executables can pass the
    kernel's per-process mapping limit (``vm.max_map_count``) inside a
    later compile, which then aborts the worker (ROADMAP C-port-5)."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One PyTorch thread per test: the suite's parallel workers share the
    cores with XLA's own thread pools, and torch's default of one thread
    per core in every worker oversubscribes them (restored after each
    test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
PRED_RTOL = 1e-12
RENAME = {"xla": "torch", "pallas": "cuda"}
CPU = "cpu"
DIM, BLOCK = 128, 32


def _renamed(s) -> tuple:
    """A reference schedule's key with its backend renamed."""
    return (s.mode, RENAME[s.backend], s.vmem_budget, s.crossover,
            s.batch_tile_max)


_PARAMS = {}


def _params(mode="int8-csd", es=0.85, dim=DIM, seed=1, block=BLOCK):
    """(reference params, port params) over the same compiled matrix,
    with a 2-output readout."""
    key = (mode, es, dim, seed, block)
    if key not in _PARAMS:
        cfg = dict(reservoir_dim=dim, element_sparsity=es, mode=mode,
                   leak=0.7, seed=seed, block=block, output_dim=2)
        ref = jesn.init_esn(jesn.ESNConfig(**cfg))
        w_out = np.random.default_rng(seed).uniform(
            -0.3, 0.3, (dim, 2)).astype(np.float32)
        ref = jesn.ESNParams(w=ref.w, w_in=ref.w_in,
                             w_out=jnp.asarray(w_out), config=ref.config)
        port = tesn.params_from_numpy(
            q=np.asarray(ref.w.q), scale=ref.w.scale, pos=ref.w.planes.pos,
            neg=ref.w.planes.neg, block_mask=ref.w.blocks.mask,
            w_in=np.asarray(ref.w_in), w_out=w_out,
            config=tesn.ESNConfig(**cfg), device=CPU)
        _PARAMS[key] = (ref, port)
    return _PARAMS[key]


def _plans(**kw):
    ref, port = _params(**kw)
    return j_plan_for(ref.w), plan_for(port.w)


def _kmode(esn_mode):
    return "fp32" if esn_mode == "fp32" else "int8"


MODES = ["fp32", "int8-pn", "int8-csd"]
SPARSITIES = [0.85, 0.97]


# -- fingerprints --------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("es", SPARSITIES)
def test_plan_fingerprint_equals_reference(mode, es):
    jp, tp = _plans(mode=mode, es=es)
    # the artefacts the digest reads are identical ...
    assert (tp.shape, tp.block, tp.mode, tp.weight_bits, tp.blocks_nnz,
            tp._fm.ones) == (jp.shape, jp.block, jp.mode, jp.weight_bits,
                             jp.blocks_nnz, jp._fm.ones)
    for a, b in ((tp.block_rows, jp.block_rows),
                 (tp.block_cols, jp.block_cols)):
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # ... and so is the digest; another matrix gets another one
    assert plan_fingerprint(tp) == jat.plan_fingerprint(jp)
    _jo, other = _plans(mode=mode, es=es, seed=2)
    assert plan_fingerprint(other) != plan_fingerprint(tp)


def test_hardware_fingerprint_follows_the_device():
    assert hardware_fingerprint(CPU) == "cpu:cpux1"
    assert hardware_fingerprint(torch.device("cpu")) == "cpu:cpux1"
    assert tat._default_model(CPU).platform == "cpu"


# -- candidates and prediction -------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("es", SPARSITIES)
def test_torch_candidates_are_the_reference_xla_ones(mode, es):
    jp, tp = _plans(mode=mode, es=es)
    km = _kmode(mode)
    want = [_renamed(s) for s in jat.candidate_schedules(jp, km, ("xla",))]
    got = [s.key() for s in candidate_schedules(tp, km, ("torch",))]
    assert got == want and len(set(got)) == len(got)
    assert default_schedule(tp, km).key() in got
    assert default_schedule(tp, km).key() == _renamed(
        jat.default_schedule(jp, km))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("es", SPARSITIES)
def test_cuda_candidates_one_budget_no_tile_above_16(mode, es):
    _jp, tp = _plans(mode=mode, es=es)
    km = _kmode(mode)
    cands = candidate_schedules(tp, km, ("cuda",))
    assert cands and {c.backend for c in cands} == {"cuda"}
    assert {c.vmem_budget for c in cands} == {tat.DEFAULT_VMEM_BUDGET}
    assert {c.batch_tile_max for c in cands} == {8, 16}

    def built(c):
        """What the launch holds: the folded planes and digits at a tile."""
        s = specialize_summary(tp, km, vmem_budget=c.vmem_budget,
                               crossover=c.crossover,
                               batch_tile_max=c.batch_tile_max)
        return (c.batch_tile_max, s["n_matmul_terms"], s["shiftadd_digits"])

    # one name per launch, and every launch the torch grid's crossovers
    # build at tiles up to 16
    got = [built(c) for c in cands]
    assert len(set(got)) == len(got)
    assert set(got) == {built(c) for c in
                        candidate_schedules(tp, km, ("torch",))
                        if c.vmem_budget == tat.DEFAULT_VMEM_BUDGET
                        and c.batch_tile_max <= 16}
    assert default_schedule(tp, km, "cuda").key() in {c.key() for c in cands}
    both = candidate_schedules(tp, km)
    assert {c.backend for c in both} == set(BACKENDS)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("batch,steps", [(2, 4), (8, 8), (16, 32), (33, 5)])
def test_predict_cost_equals_reference_for_every_torch_candidate(mode, batch,
                                                                 steps):
    jp, tp = _plans(mode=mode, es=0.97)
    km = _kmode(mode)
    jmodel = jat.costmodel.default_rollout_cost_model("cpu")
    for js in jat.candidate_schedules(jp, km):
        ts = Schedule(*_renamed(js))
        want = jat.predict_cost(jp, js, batch, steps, jmodel)
        got = predict_cost(tp, ts, batch, steps, device=CPU)
        assert got == pytest.approx(want, rel=PRED_RTOL, abs=0.0)


# -- resolution ----------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("es", SPARSITIES)
@pytest.mark.parametrize("batch,steps", [(8, 8), (16, 32)])
def test_cold_resolution_picks_reference_schedule(mode, es, batch, steps):
    jp, tp = _plans(mode=mode, es=es)
    km = _kmode(mode)
    want = jat.resolve_schedule(jp, km, batch=batch, steps=steps,
                                cache=jat.ScheduleCache())
    got = resolve_schedule(tp, km, batch=batch, steps=steps,
                           cache=ScheduleCache(), device=CPU)
    assert want.source == got.source == "predicted"
    assert got.schedule.key() == _renamed(want.schedule)
    assert got.schedule.backend == "torch"
    assert got.predicted_s == pytest.approx(want.predicted_s,
                                            rel=PRED_RTOL, abs=0.0)
    assert got.default_predicted_s == pytest.approx(
        want.default_predicted_s, rel=PRED_RTOL, abs=0.0)
    assert got.n_candidates == len(candidate_schedules(tp, km))
    # deterministic: a second cold resolution picks the same
    again = resolve_schedule(tp, km, batch=batch, steps=steps,
                             cache=ScheduleCache(), device=CPU)
    assert again.schedule == got.schedule


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("es", SPARSITIES)
@pytest.mark.parametrize("batch,steps", [(8, 8), (16, 32)])
def test_card_prior_cold_pick_keeps_the_default_knobs(mode, es, batch,
                                                      steps):
    """Under the card's prior the cold pick is the default ``cuda``
    schedule, and no candidate with the default budget and crossover is
    predicted cheaper (at batch 8 tiles 8 and 16 price the same)."""
    _jp, tp = _plans(mode=mode, es=es)
    km = _kmode(mode)
    prior = tcm.default_rollout_cost_model("cuda")
    got = resolve_schedule(tp, km, batch=batch, steps=steps,
                           cache=ScheduleCache(), model=prior, device=CPU)
    assert got.schedule.key() == default_schedule(tp, km, "cuda").key()
    assert got.predicted_s == predict_cost(tp, got.schedule, batch, steps,
                                           prior)
    # no candidate is predicted cheaper on the axes the prior decides
    for s in candidate_schedules(tp, km):
        if (s.vmem_budget == tat.DEFAULT_VMEM_BUDGET
                and s.crossover == got.schedule.crossover):
            assert predict_cost(tp, s, batch, steps, prior) >= \
                got.predicted_s


@pytest.mark.parametrize("mode", ["fp32", "int8"])
@pytest.mark.parametrize("dim,block,es", [(128, 32, 0.85), (1024, 128, 0.95)])
def test_card_prior_cold_resolution_enumerates_no_candidate(
        monkeypatch, mode, dim, block, es):
    """Under the card's prior a cold resolution serves the default
    ``cuda`` schedule, priced alone, without enumerating candidates;
    it is cached and pinned as any resolution is."""
    rng = np.random.default_rng(0)
    plan = plan_for(FixedMatrix.compile(
        random_sparse_matrix(dim, dim, es, rng) * 0.05, weight_bits=8,
        mode="csd", block=block, rng=rng))

    def refuse(*_a, **_k):
        raise AssertionError("candidate_schedules called")

    monkeypatch.setattr(tat, "candidate_schedules", refuse)
    prior = tcm.default_rollout_cost_model("cuda")
    cache = ScheduleCache()
    got = resolve_schedule(plan, mode, cache=cache, model=prior, device=CPU)
    want = default_schedule(plan, mode, "cuda")
    assert got.schedule == want
    assert (got.source, got.n_candidates, got.measured_s) == (
        "predicted", 1, None)
    assert got.predicted_s == got.default_predicted_s == predict_cost(
        plan, want, tat.TUNE_BATCH, tat.TUNE_STEPS, prior)
    assert len(cache) == 1 and cache.misses == 1
    again = resolve_schedule(plan, mode, cache=cache, model=prior,
                             device=CPU)
    assert again is got and cache.hits == 1
    assert "autotuned[" + mode in plan.describe()


@pytest.mark.parametrize("mode", MODES)
def test_resolve_backend_is_torch_where_reference_is_xla(mode):
    ref, port = _params(mode=mode)
    assert jat.resolve_backend(ref) == "xla"
    assert resolve_backend(port) == "torch"
    assert resolve_backend(port, "cuda") == "cuda"


def test_describe_reports_tuned_schedule():
    _jp, tp = _plans(mode="int8-csd", es=0.97)
    tuned = resolve_schedule(tp, "int8", device=CPU)
    text = tp.describe()
    assert "autotuned[int8 b<=8 cpu:cpux1]: " + tuned.describe() in text


# -- measured tuning -----------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_measured_winner_never_loses_and_serves_default_bits(mode):
    ref, port = _params(mode=mode, es=0.97, dim=64)
    tp = plan_for(port.w)
    km = _kmode(mode)
    tuned = autotune_rollout(tp, km, batch=4, steps=4, params=port,
                             top_k=2, reps=1, cache=ScheduleCache(),
                             device=CPU)
    assert tuned.source == "measured"
    assert tuned.measured_s is not None and tuned.measured_s > 0
    default = default_schedule(tp, km)
    trial_keys = [Schedule.from_dict(s).key() for s, _p, _m in tuned.trials]
    assert default.key() in trial_keys and len(trial_keys) == 3
    assert tuned.schedule.key() in trial_keys
    assert tuned.default_measured_s >= tuned.measured_s
    assert tuned.measured_s == min(m for _s, _p, m in tuned.trials)
    # interpret-mode cuda never survives pruning on the CPU
    assert {Schedule.from_dict(s).backend for s, _p, _m in tuned.trials} \
        == {"torch"}
    # a JSON round trip keeps every field
    back = TunedSchedule.from_dict(json.loads(json.dumps(tuned.as_dict())))
    assert back == tuned
    # the winner serves the default's bits (int8), as does the reference
    rng = np.random.default_rng(9)
    u = rng.standard_normal((4, 6, 1)).astype(np.float32)
    eng = ReservoirEngine(port, schedule=tuned)
    base = ReservoirEngine(port, schedule=default)
    assert eng.schedule == tuned.schedule and eng.backend == "torch"
    got_s, want_s = eng.rollout(u), base.rollout(u)
    got_p, want_p = eng.predictions(u), base.predictions(u)
    if km == "int8":
        assert torch.equal(got_s, want_s) and torch.equal(got_p, want_p)
    ref_s = np.asarray(JEngine(ref, backend="xla").rollout(jnp.asarray(u)))
    np.testing.assert_allclose(got_s.numpy(), ref_s, atol=1e-5)


def test_trials_emit_spans_events_and_counters():
    _ref, port = _params(mode="int8-csd", es=0.97, dim=64)
    tp = plan_for(port.w)
    cache = ScheduleCache()
    obs.configure()
    try:
        autotune_rollout(tp, "int8", batch=2, steps=2, params=port, top_k=1,
                         reps=1, cache=cache, device=CPU)
        resolve_schedule(tp, "int8", batch=2, steps=2, cache=cache,
                         device=CPU)
        spans = [s for s in obs.tracer().spans()
                 if s.name == "autotune.trial"]
        assert len(spans) == 2          # top-1 and the default
        assert obs.events().count("schedule_resolve") == 2
        text = obs.metrics().prometheus_text()
        assert 'schedule_cache_requests_total{outcome="miss"} 1' in text
        assert 'schedule_cache_requests_total{outcome="hit"} 1' in text
    finally:
        obs.disable()


# -- the cache -----------------------------------------------------------------
def test_cache_roundtrip_and_zero_retune(tmp_path):
    _ref, port = _params(mode="int8-pn", es=0.97, dim=64)
    tp = plan_for(port.w)
    cache = ScheduleCache()
    tuned = autotune_rollout(tp, "int8", batch=4, steps=4, params=port,
                             top_k=1, reps=1, cache=cache, device=CPU)
    path = tmp_path / "autotune_cache.json"
    cache.save(path)
    fresh = ScheduleCache()
    assert fresh.load(path) == len(cache) >= 1
    calls = []
    orig = tat._measure_schedule
    tat._measure_schedule = lambda *a, **k: calls.append(a) or orig(*a, **k)
    try:
        replay = resolve_schedule(tp, "int8", batch=4, steps=4, cache=fresh,
                                  device=CPU)
        again = autotune_rollout(tp, "int8", batch=4, steps=4, params=port,
                                 cache=fresh, device=CPU)
    finally:
        tat._measure_schedule = orig
    assert calls == []                # nothing measured: replayed
    assert replay.source == again.source == "cache"
    assert replay.schedule == tuned.schedule
    assert replay.measured_s == tuned.measured_s
    assert replay.trials == tuned.trials


def test_cache_refuses_the_reference_files(tmp_path):
    repo_file = ROOT / "AUTOTUNE_cache.json"
    assert json.loads(repo_file.read_text())["version"] == 1
    for path in (repo_file,):
        cache = ScheduleCache()
        with pytest.raises(ValueError, match="version 1"):
            cache.load(path)
        assert len(cache) == 0
    # a reference entry under the port's version: its backend is refused
    data = json.loads(repo_file.read_text())
    data["version"] = ScheduleCache.VERSION
    bad = tmp_path / "renumbered.json"
    bad.write_text(json.dumps(data))
    cache = ScheduleCache()
    with pytest.raises(ValueError, match="backend"):
        cache.load(bad)
    assert len(cache) == 0


def test_cache_rejects_wrong_version(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"version": 999, "entries": {}}))
    with pytest.raises(ValueError, match="version"):
        ScheduleCache().load(path)


def test_cache_stats_like_reference():
    jp, tp = _plans(mode="int8-csd", es=0.97)
    jc, tc = jat.ScheduleCache(), ScheduleCache()
    for batch in (8, 8, 16, 5, 16):
        jat.resolve_schedule(jp, "int8", batch=batch, cache=jc)
        resolve_schedule(tp, "int8", batch=batch, cache=tc, device=CPU)
        assert tc.stats() == jc.stats()
    assert tc.stats() == {"size": 2, "hits": 3, "misses": 2}
    assert ScheduleCache.entry_key("f", "int8", 5, "cpu:cpux1") == \
        jat.ScheduleCache.entry_key("f", "int8", 5, "cpu:cpux1")
    tc.clear()
    assert tc.stats() == {"size": 0, "hits": 0, "misses": 0}


# -- the engine ----------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_auto_engine_resolves_like_reference(mode):
    ref, port = _params(mode=mode, es=0.97)
    jeng, teng = JEngine(ref), ReservoirEngine(port)
    assert jeng.backend == "xla" and teng.backend == "torch"
    assert teng.requested_backend == "auto"
    assert teng.schedule.key() == _renamed(jeng.schedule)
    assert (teng.vmem_budget, teng.crossover, teng.batch_tile_max) == (
        jeng.vmem_budget, jeng.crossover, jeng.batch_tile_max)
    assert teng.schedule == resolve_schedule(
        plan_for(port.w), _kmode(mode), device=CPU).schedule


def test_engine_for_key_and_backend_agree():
    engine_cache_clear()
    engine_cache_stats(reset=True)
    _ref, port = _params(mode="int8-csd", es=0.97)
    eng = engine_for(port)
    assert eng.backend == resolve_backend(port, "auto") == "torch"
    assert engine_for(port, eng.backend) is eng
    assert engine_for(port) is eng
    assert engine_cache_stats()["hits"] >= 2
    engine_cache_clear()


def test_schedule_bypasses_resolution():
    _ref, port = _params(mode="int8-csd", es=0.97)
    tp = plan_for(port.w)
    sched = dataclasses.replace(default_schedule(tp, "int8", "cuda"),
                                crossover=0, batch_tile_max=8)
    before = tat.autotune_cache().stats()
    eng = ReservoirEngine(port, schedule=sched)
    assert tat.autotune_cache().stats() == before
    assert eng.backend == "cuda" and eng.schedule == sched
    assert (eng.crossover, eng.batch_tile_max) == (0, 8)
    assert eng.program.crossover == 0 and eng.program.batch_tile_max == 8
    # a TunedSchedule works too, and engine_for keys on its backend
    tuned = TunedSchedule(schedule=sched, batch=8, steps=8, predicted_s=1.0)
    assert ReservoirEngine(port, schedule=tuned).schedule == sched
    assert engine_for(port, schedule=tuned).backend == "cuda"
    # an explicit backend wins over the schedule's
    assert ReservoirEngine(port, backend="torch",
                           schedule=sched).backend == "torch"


def test_explicit_kwargs_beat_tuned_schedule():
    _ref, port = _params(mode="int8-csd", es=0.97)
    eng = ReservoirEngine(port, vmem_budget=12345, crossover=7,
                          batch_tile_max=4)
    assert eng.vmem_budget == 12345
    assert eng.crossover == 7 and eng.batch_tile_max == 4
    # None is an explicit budget (forced resident), not "unset"
    assert ReservoirEngine(port, vmem_budget=None).vmem_budget is None


def test_unspecialized_auto_is_torch_on_the_cpu():
    ref, port = _params(mode="fp32")
    jeng = JEngine(ref, specialize=False)
    eng = ReservoirEngine(port, specialize=False)
    assert jeng.backend == "xla" and jeng.schedule is None
    assert eng.backend == "torch" and eng.schedule is None
    assert engine_for(port, specialize=False).backend == "torch"
