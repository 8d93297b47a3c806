"""Server-driven fault plans in the port against the JAX package's.

The server cases of ``tests/test_faults.py``: the reference (``"xla"``)
and the port (``"torch"`` and ``"cuda"``, the latter on its CPU twins)
serve the same seeded requests with the same :class:`FaultPlan`.  The
virtual clock, retry counts and completions must be identical; outputs
agree with the reference within ``TOL`` and, inside the port, a run with
faults equals the fault-free run bit for bit (a retry replays the same
operands; a straggler window only inflates the clock).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.serve as jserve
from repro.core import esn as jesn
from repro.runtime import faults as jfaults
from repro_torch.core import esn as tesn
from repro_torch.runtime import faults
from repro_torch.runtime.faults import (FaultEvent, FaultPlan,
                                        PublishAborted, TransientFault)
from repro_torch.serve import (AsyncReservoirServer, ModelRegistry,
                               ReservoirEngine, ServeStats, SubmitSpec)


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


TOL = 1e-5
BACKENDS = ["torch", "cuda"]
_PARAMS = {}


@pytest.fixture(autouse=True)
def _clear_installed_plans():
    yield
    faults.install(None)
    jfaults.install(None)


def _params(seed=1):
    """(reference, port) params: test_faults.py's reservoir, carried."""
    if seed not in _PARAMS:
        cfg = dict(reservoir_dim=96, element_sparsity=0.8, mode="fp32",
                   leak=0.7, seed=seed, block=32, output_dim=2)
        p = jesn.init_esn(jesn.ESNConfig(**cfg))
        rng = np.random.default_rng(seed)
        u = jnp.asarray(rng.standard_normal((50, 1)), jnp.float32)
        states = jesn.run_reservoir(p, u, engine="scan")
        y = jnp.concatenate([u, jnp.roll(u, 1)], axis=-1)
        ref = jesn.fit_readout(p, states, y, lam=1e-2)
        port = tesn.params_from_numpy(
            q=np.asarray(ref.w.q), scale=ref.w.scale, pos=ref.w.planes.pos,
            neg=ref.w.planes.neg, block_mask=ref.w.blocks.mask,
            w_in=np.asarray(ref.w_in), w_out=np.asarray(ref.w_out),
            config=tesn.ESNConfig(**cfg), device="cpu")
        _PARAMS[seed] = (ref, port)
    return _PARAMS[seed]


def _events(kind, **kw):
    """The same plan's events for both packages: (reference, port)."""
    return ([jfaults.FaultEvent(kind, **kw)], [FaultEvent(kind, **kw)])


def _serve(pkg, backend, lengths, seed, plan=None, zero_copy=None, **kw):
    """Serve one seeded burst (all arrivals at 0) on a fresh server of
    ``pkg`` ("j": reference, "t": port); returns (server, results)."""
    ref, port = _params()
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((n, 1)).astype(np.float32)
              for n in lengths]
    if pkg == "j":
        srv = jserve.AsyncReservoirServer(
            jserve.ReservoirEngine(ref, backend="xla",
                                   stats=jserve.ServeStats()),
            stats=jserve.ServeStats(), chunk_time=1.0, fault_plan=plan,
            **kw)
        spec_cls = jserve.SubmitSpec
    else:
        srv = AsyncReservoirServer(
            ReservoirEngine(port, backend=backend, stats=ServeStats()),
            stats=ServeStats(), chunk_time=1.0, fault_plan=plan,
            zero_copy=zero_copy, **kw)
        spec_cls = SubmitSpec
    for i, a in enumerate(arrays):
        srv.submit(spec_cls(a, uid=i), arrival_time=0.0)
    return srv, srv.run()


@pytest.mark.parametrize("zero_copy", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_transient_retry_replays_bit_identical(backend, zero_copy):
    jev, tev = _events("transient", at=0.0, count=3)
    jplan, tplan = jfaults.FaultPlan(jev), FaultPlan(tev)
    lengths, kw = [8, 8, 8, 8], dict(n_slots=2, chunk_steps=4)
    j, jres = _serve("j", backend, lengths, 5, jplan, **kw)
    t, tres = _serve("t", backend, lengths, 5, tplan, zero_copy, **kw)
    _c, clean = _serve("t", backend, lengths, 5, None, zero_copy, **kw)
    assert tplan.injected == jplan.injected == {"transient": 1}
    assert t.stats.retries == j.stats.retries == 3
    assert t.stats.completed == 4 and t.now == j.now
    for uid in clean:
        np.testing.assert_array_equal(tres[uid].preds, clean[uid].preds)
        np.testing.assert_allclose(tres[uid].preds,
                                   np.asarray(jres[uid].preds), atol=TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_no_carry_written_in_place_while_a_plan_is_attached(backend):
    """A retry must restart from the pre-chunk state, so with a fault plan
    attached the zero-copy pool never donates its carry (without one, a
    single-model chunk does)."""
    seen = []
    for plan in (None, FaultPlan()):
        _ref, port = _params()
        eng = ReservoirEngine(port, backend=backend)
        real = eng.run_segment

        def spy(*a, **k):
            seen.append((plan is None, k["donate_state"]))
            return real(*a, **k)

        eng.run_segment = spy
        srv = AsyncReservoirServer(eng, n_slots=2, chunk_steps=4,
                                   chunk_time=1.0, zero_copy=True,
                                   fault_plan=plan)
        srv.submit(SubmitSpec(np.ones((8, 1), np.float32)))
        srv.run()
    assert {d for free, d in seen if free} == {True}
    assert {d for free, d in seen if not free} == {False}


@pytest.mark.parametrize("backend", BACKENDS)
def test_backoff_charged_to_virtual_clock(backend):
    jev, tev = _events("transient", at=0.0, count=3)
    jplan = jfaults.FaultPlan(jev, backoff_base_s=0.001)
    tplan = FaultPlan(tev, backoff_base_s=0.001)
    kw = dict(n_slots=2, chunk_steps=4)
    j, _ = _serve("j", backend, [8, 8], 6, jplan, **kw)
    t, _ = _serve("t", backend, [8, 8], 6, tplan, **kw)
    # 2 chunks of 1.0 plus 0.001 + 0.002 + 0.004 of backoff
    assert t.now == j.now == pytest.approx(2.007)


@pytest.mark.parametrize("backend", BACKENDS)
def test_exhausted_attempts_propagate(backend):
    _jev, tev = _events("transient", at=0.0, count=5)
    with pytest.raises(TransientFault):
        _serve("t", backend, [4], 7, FaultPlan(tev, max_attempts=2),
               n_slots=1, chunk_steps=4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_straggler_inflates_clock_not_outputs(backend):
    jev, tev = _events("slow_shard", at=0.0, factor=3.0, duration=2.0)
    kw = dict(n_slots=2, chunk_steps=4)
    _c, clean = _serve("t", backend, [8, 8], 8, **kw)
    j, jres = _serve("j", backend, [8, 8], 8, jfaults.FaultPlan(jev), **kw)
    t, tres = _serve("t", backend, [8, 8], 8, FaultPlan(tev), **kw)
    # chunk 1 inside the window costs 3.0; chunk 2 (t=3.0) is past it
    assert t.now == j.now == pytest.approx(4.0)
    for uid in clean:
        np.testing.assert_array_equal(tres[uid].preds, clean[uid].preds)
        np.testing.assert_allclose(tres[uid].preds,
                                   np.asarray(jres[uid].preds), atol=TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_seeded_plan_serves_like_reference(backend):
    """A seeded plan of transients and straggler windows: the same events
    in both packages, the same clock and retries, bit-identical outputs
    to the port's fault-free run."""
    kw = dict(horizon=12.0, n_shards=1, transient_rate=0.4, slow_rate=0.3)
    jplan, tplan = jfaults.FaultPlan.seeded(3, **kw), FaultPlan.seeded(3, **kw)
    assert [(e.kind, e.at) for e in tplan.events] == \
        [(e.kind, e.at) for e in jplan.events]
    lengths, pool = [12, 20, 7, 16, 9], dict(n_slots=2, chunk_steps=4)
    _c, clean = _serve("t", backend, lengths, 9, **pool)
    j, jres = _serve("j", backend, lengths, 9, jplan, **pool)
    t, tres = _serve("t", backend, lengths, 9, tplan, **pool)
    assert t.stats.retries == j.stats.retries > 0
    assert t.now == pytest.approx(j.now) and t.now > _c.now
    for uid in clean:
        np.testing.assert_array_equal(tres[uid].preds, clean[uid].preds)
        np.testing.assert_allclose(tres[uid].preds,
                                   np.asarray(jres[uid].preds), atol=TOL)


def test_publish_abort_leaves_active_version_then_retry_succeeds():
    (r1, p1), (r2, p2) = _params(1), _params(2)
    outs = {}
    for pkg, reg, plan, mod, a, b in (
            ("j", jserve.ModelRegistry(backend="xla"), jfaults.FaultPlan(),
             jfaults, r1, r2),
            ("t", ModelRegistry(backend="torch"), FaultPlan(), faults,
             p1, p2)):
        reg.register("m", a)
        plan.arm_publish_abort()
        mod.install(plan)
        with pytest.raises(mod.PublishAborted, match="stays"):
            reg.publish("m", b)
        staged = (reg.active_version("m"), reg.versions("m"))
        out = reg.publish("m", version=2)
        outs[pkg] = (staged, reg.active_version("m"), out["version"],
                     out["previous_version"], len(out["actions"]))
    assert outs["t"] == outs["j"] == (((1, [1, 2])), 2, 2, 1, 5)
    assert PublishAborted is faults.PublishAborted


@pytest.mark.parametrize("backend", BACKENDS)
def test_serving_unaffected_across_publish_abort(backend):
    _r1, p1 = _params(1)
    _r2, p2 = _params(2)
    reg = ModelRegistry(backend=backend)
    reg.register("m", p1)
    eng = reg.engine("m")
    eng.stats = ServeStats()
    srv = AsyncReservoirServer(eng, n_slots=2, chunk_steps=4,
                               chunk_time=1.0, registry=reg,
                               stats=ServeStats())
    u = np.ones((8, 1), np.float32)
    srv.submit(SubmitSpec(u, model="m", uid="ref"), arrival_time=0.0)
    before = srv.run()["ref"]
    plan = FaultPlan()
    plan.arm_publish_abort()
    faults.install(plan)
    with pytest.raises(PublishAborted):
        reg.publish("m", p2)
    srv.submit(SubmitSpec(u, model="m", uid="r0"), arrival_time=0.0)
    res = srv.run()
    np.testing.assert_array_equal(res["r0"].output, before.output)
    assert res["r0"].timings["version"] == 1
