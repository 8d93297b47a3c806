"""The multi-tenant registry in the port against the JAX package's.

The cases of ``tests/test_registry.py``: the reference (``"xla"``) and the
port (``"torch"`` and ``"cuda"``, the latter on its CPU twins) register the
same weights (carried with ``params_from_numpy``) and serve the same
seeded traces.  Versions pinned, admission times, quota holds and drops
must be identical; outputs agree with the reference within ``TOL``.
Inside the port every answer equals its pinned version's engine at the
pool's batch shape bit for bit (rows are independent, so broadcasting the
request over all slots gives the exact bits of its pool row), and a
``publish()`` prewarms everything serving then runs (``trace_counts``
unchanged by post-swap traffic).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.serve as jserve
from repro.core import esn as jesn
from repro.plan import plan_cache_stats as j_plan_cache_stats
from repro_torch.core import esn as tesn
from repro_torch.plan import plan_cache_stats
from repro_torch.serve import (AsyncReservoirServer, ModelRegistry,
                               ReservoirEngine, ServeStats, SubmitSpec,
                               engine_cache_clear, engine_cache_stats,
                               engine_for)
from repro_torch.serve import engine as engine_mod


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
DIM = 64
BACKENDS = ["torch", "cuda"]
_PARAMS = {}


def _params(seed=1, leak=0.7, mode="fp32"):
    """(reference, port) params: test_registry.py's reservoir, carried."""
    key = (seed, leak, mode)
    if key not in _PARAMS:
        cfg = dict(reservoir_dim=DIM, element_sparsity=0.8, mode=mode,
                   leak=leak, seed=seed, block=32, output_dim=2)
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
        _PARAMS[key] = (ref, port)
    return _PARAMS[key]


def _pool_ref(engine, inputs, n_slots):
    """One-shot answer at the POOL batch shape (the request broadcast over
    every slot): the exact bits of its pool row."""
    batch = torch.as_tensor(np.broadcast_to(
        inputs[None], (n_slots,) + inputs.shape).copy())
    return engine.predictions(batch)[0].numpy()


def _server(pkg, reg, **kw):
    """A server over ``reg`` whose default engine is its first model's."""
    mod = jserve if pkg == "j" else None
    eng = reg.engine(reg.models[0])
    if pkg == "j":
        eng.stats = mod.ServeStats()
        return mod.AsyncReservoirServer(eng, chunk_time=1.0, registry=reg,
                                        stats=mod.ServeStats(), **kw)
    eng.stats = ServeStats()
    return AsyncReservoirServer(eng, chunk_time=1.0, registry=reg,
                                stats=ServeStats(), **kw)


def _registries(backend, models):
    """The same registrations in both packages: models is a list of
    (name, params key, register kwargs)."""
    j, t = jserve.ModelRegistry(backend="xla"), ModelRegistry(backend=backend)
    for name, key, kw in models:
        ref, port = _params(*key)
        j.register(name, ref, **kw)
        t.register(name, port, **kw)
    return j, t


def test_register_version_activate_and_rollback():
    outs = {}
    for pkg in ("j", "t"):
        reg = (jserve.ModelRegistry(backend="xla") if pkg == "j"
               else ModelRegistry(backend="torch"))
        pick = 0 if pkg == "j" else 1
        v1 = reg.register("m", _params(1)[pick])
        v2 = reg.register("m", _params(2)[pick])
        with pytest.raises(ValueError, match="immutable"):
            reg.register("m", _params(3)[pick], version=2)
        plan = reg.publish("m", version=1)       # rollback
        with pytest.raises(KeyError):
            reg.active_version("ghost")
        with pytest.raises(KeyError, match="no version"):
            reg.get("m", 9)
        with pytest.raises(ValueError, match="params"):
            reg.publish("m")
        outs[pkg] = (v1.version, v2.version, v1.key, reg.versions("m"),
                     reg.models, reg.active_version("m"),
                     plan["previous_version"], plan["version"],
                     len(plan["actions"]), plan["prewarm_s"] >= 0.0)
    assert outs["t"] == outs["j"] == (1, 2, ("m", 1), [1, 2], ["m"], 1, 2,
                                      1, 5, True)


def test_engine_cache_keyed_on_registry_identity():
    """Two versions with VALUE-equal params get distinct cached engines —
    (name, version) is the key, not tensor identity."""
    engine_cache_clear()
    engine_cache_stats(reset=True)
    _ref, p = _params(4)
    reg = ModelRegistry(backend="torch")
    reg.register("m", p)
    reg.register("m", dataclasses.replace(p))
    e1, e2 = reg.engine("m", 1), reg.engine("m", 2)
    assert e1 is not e2 and reg.engine("m", 1) is e1
    st = engine_cache_stats()
    assert st["tenants"]["m"]["misses"] == 2
    assert st["tenants"]["m"]["hits"] >= 1
    assert e1.tenant == "m"
    engine_cache_clear()


def test_plan_cache_tenant_counters_like_reference():
    plan_cache_stats(reset=True)
    j_plan_cache_stats(reset=True)
    jreg, treg = _registries("torch", [("counted", (5,), {})])
    jreg.engine("counted")
    treg.engine("counted")
    got = plan_cache_stats()["tenants"]["counted"]
    want = j_plan_cache_stats()["tenants"]["counted"]
    assert got["hits"] + got["misses"] >= 1
    assert got["misses"] == want["misses"] == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_registry_submit_one_shot(backend):
    jreg, treg = _registries(backend, [("m", (1,), {})])
    u = np.ones((9, 1), np.float32)
    res = treg.submit(SubmitSpec(u, model="m"))
    want = jreg.submit(jserve.SubmitSpec(u, model="m"))
    assert res.preds.shape == (9, 2) and res.final_state.shape == (DIM,)
    np.testing.assert_allclose(res.preds.numpy(), np.asarray(want.preds),
                               atol=TOL)
    with pytest.raises(ValueError, match="spec.model"):
        treg.submit(SubmitSpec(u))


def test_bare_engine_and_server_reject_model_spec():
    _ref, port = _params(1)
    eng = ReservoirEngine(port, backend="torch")
    u = np.ones((4, 1), np.float32)
    with pytest.raises(ValueError, match="registry"):
        eng.submit(SubmitSpec(u, model="m"))
    with pytest.raises(ValueError, match="registry"):
        eng.submit_many([SubmitSpec(u, model="m")])
    srv = AsyncReservoirServer(ReservoirEngine(port, stats=ServeStats()),
                               n_slots=1, chunk_time=1.0)
    with pytest.raises(ValueError, match="no registry"):
        srv.submit(SubmitSpec(u, model="m"))


def test_mismatched_dims_rejected_in_shared_pool():
    small = tesn.ESNConfig(reservoir_dim=32, element_sparsity=0.8,
                           mode="fp32", leak=0.7, seed=9, block=32,
                           output_dim=2)
    reg = ModelRegistry(backend="torch")
    reg.register("big", _params(1)[1])
    reg.register("small", tesn.init_esn(small, device="cpu"))
    srv = _server("t", reg, n_slots=2, chunk_steps=8)
    srv.submit(SubmitSpec(np.ones((8, 1), np.float32), model="small",
                          want_states=True))
    with pytest.raises(ValueError, match="share input/reservoir dims"):
        srv.run()


# (name, params key, register kwargs): B2's specialized int8 model beside
# B1's generic one, and two fp32 models
_MIXES = {
    "fp32": [("A", (1,), {}), ("B", (2, 0.55), {})],
    "int8-specialized-and-generic": [
        ("A", (1, 0.7, "int8-csd"), {}),
        ("B", (2, 0.55, "int8-csd"), {"specialize": False})],
}


@pytest.mark.parametrize("zero_copy", [False, True])
@pytest.mark.parametrize("mix", list(_MIXES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_interleaved_tenants_bit_identical_to_single_tenant(backend, mix,
                                                            zero_copy):
    """A/B interleaved in one pool == each served alone at the pool shape,
    bit for bit; within TOL of the reference's interleaved pool."""
    jreg, treg = _registries(backend, _MIXES[mix])
    rng = np.random.default_rng(0)
    n, t = 4, 24
    inputs = [rng.standard_normal((t, 1)).astype(np.float32)
              for _ in range(n)]
    jsrv = _server("j", jreg, n_slots=n, chunk_steps=8)
    tsrv = _server("t", treg, n_slots=n, chunk_steps=8, zero_copy=zero_copy)
    for i, u in enumerate(inputs):
        model = "A" if i % 2 == 0 else "B"
        jsrv.submit(jserve.SubmitSpec(u, model=model, uid=i),
                    arrival_time=0.0)
        tsrv.submit(SubmitSpec(u, model=model, uid=i), arrival_time=0.0)
    jres, tres = jsrv.run(), tsrv.run()
    batch = torch.as_tensor(np.stack(inputs))
    ref = {m: treg.engine(m).predictions(batch).numpy() for m in "AB"}
    for i in range(n):
        model = "A" if i % 2 == 0 else "B"
        np.testing.assert_array_equal(tres[i].output, ref[model][i])
        np.testing.assert_allclose(tres[i].output,
                                   np.asarray(jres[i].output), atol=TOL)
        assert tres[i].timings["model"] == model
        assert tres[i].timings["version"] == 1
    ts = tsrv.tenant_summary()
    assert ts.completed == n
    assert ts.shards["A"].completed == ts.shards["B"].completed == 2


@pytest.mark.parametrize("zero_copy", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_mid_traffic_swap_bit_exact_zero_drops(backend, zero_copy):
    """A Poisson trace against model "m"; v2 published mid-flight.  Every
    request completes, each answer is bit-exact against its pinned
    version's engine, and the pins are the reference's."""
    (r1, p1), (r2, p2) = _params(1), _params(7, 0.5)
    rng = np.random.default_rng(3)
    n_slots, t, n_req = 4, 24, 14
    inputs = [rng.standard_normal((t, 1)).astype(np.float32)
              for _ in range(n_req)]
    arrivals = np.cumsum(rng.exponential(0.4, n_req))
    arrivals -= arrivals[0]
    runs = {}
    for pkg in ("j", "t"):
        reg = (jserve.ModelRegistry(backend="xla") if pkg == "j"
               else ModelRegistry(backend=backend))
        reg.register("m", r1 if pkg == "j" else p1)
        kw = {} if pkg == "j" else {"zero_copy": zero_copy}
        srv = _server(pkg, reg, n_slots=n_slots, chunk_steps=8, **kw)
        spec_cls = jserve.SubmitSpec if pkg == "j" else SubmitSpec
        handles = [srv.submit(spec_cls(u, model="m", uid=i),
                              arrival_time=float(at))
                   for i, (u, at) in enumerate(zip(inputs, arrivals))]
        swapped_at = None
        while srv.step():
            if swapped_at is None and srv.stats.completed >= 3:
                assert srv.batcher.live > 0      # genuinely mid-traffic
                assert reg.publish("m", r2 if pkg == "j" else p2)[
                    "version"] == 2
                swapped_at = srv.now
        runs[pkg] = (reg, srv, handles, swapped_at)
    reg, srv, handles, swapped_at = runs["t"]
    _jreg, jsrv, jhandles, jswapped = runs["j"]
    res = srv.results
    assert len(res) == n_req and srv.stats.timed_out == 0
    assert swapped_at == jswapped
    pinned = [q.pinned_version for q in handles]
    assert pinned == [q.pinned_version for q in jhandles]
    assert set(pinned) == {1, 2}
    engines = {v: reg.engine("m", v) for v in (1, 2)}
    for i, q in enumerate(handles):
        np.testing.assert_array_equal(
            res[i].output, _pool_ref(engines[q.pinned_version], inputs[i],
                                     n_slots))
        np.testing.assert_allclose(res[i].output,
                                   np.asarray(jsrv.results[i].output),
                                   atol=TOL)
        assert res[i].timings["version"] == q.pinned_version
    assert all(q.pinned_version == 1 for q in handles
               if q.admit_time is not None and q.admit_time < swapped_at)


@pytest.mark.parametrize("zero_copy", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_publish_prewarms_before_cutover(backend, zero_copy):
    """publish() runs the new version's chunk call against the pool shape:
    serving after the swap sets up nothing new, and the retired version
    sits at the LRU's eviction front."""
    reg = ModelRegistry(backend=backend)
    reg.register("m", _params(1)[1])
    srv = _server("t", reg, n_slots=2, chunk_steps=8, zero_copy=zero_copy)
    srv.submit(SubmitSpec(np.ones((8, 1), np.float32), model="m",
                          uid="warm"))
    srv.run()
    reg.publish("m", _params(8)[1])
    e2 = reg.engine("m", 2)
    after_publish = dict(e2.trace_counts)
    assert after_publish
    srv.submit(SubmitSpec(np.ones((8, 1), np.float32), model="m",
                          uid="post"))
    srv.run()
    assert dict(e2.trace_counts) == after_publish
    assert srv.results["post"].timings["version"] == 2
    assert next(iter(engine_mod._engine_cache))[0] == ("m", 1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_quota_holds_without_head_of_line_blocking(backend):
    models = [("A", (1,), {}), ("B", (2,), {"quota": 1})]
    jreg, treg = _registries(backend, models)
    trails = {}
    for pkg, reg in (("j", jreg), ("t", treg)):
        srv = _server(pkg, reg, n_slots=3, chunk_steps=8)
        spec_cls = jserve.SubmitSpec if pkg == "j" else SubmitSpec
        for i in range(2):
            srv.submit(spec_cls(np.ones((16, 1), np.float32), model="B",
                                uid=f"b{i}"), arrival_time=0.0)
        srv.submit(spec_cls(np.ones((8, 1), np.float32), model="A",
                            uid="a0"), arrival_time=0.0)
        max_b_live = 0
        while srv.step():
            max_b_live = max(max_b_live, sum(
                1 for q in srv.batcher._slots
                if q is not None and q.model == "B"))
        trails[pkg] = (max_b_live, sorted(srv.results),
                       srv.stats.quota_held,
                       srv.tenant_stats["B"].quota_held,
                       srv.tenant_stats["A"].quota_held,
                       {u: r.timings["admit_time"]
                        for u, r in srv.results.items()})
    assert trails["t"] == trails["j"]
    max_b, done, held, held_b, held_a, admits = trails["t"]
    assert max_b == 1 and len(done) == 3 and held > 0 and held_b > 0
    assert held_a == 0 and admits["a0"] == 0.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_registry_deadline_policy_applies_to_specs(backend):
    jreg, treg = _registries(backend, [("m", (1,), {"deadline_s": 1.5})])
    outs = {}
    for pkg, reg in (("j", jreg), ("t", treg)):
        srv = _server(pkg, reg, n_slots=1, chunk_steps=8)
        spec_cls = jserve.SubmitSpec if pkg == "j" else SubmitSpec
        srv.submit(spec_cls(np.ones((32, 1), np.float32), model="m",
                            uid="busy"), arrival_time=0.0)
        doomed = srv.submit(spec_cls(np.ones((8, 1), np.float32),
                                     model="m", uid="late"),
                            arrival_time=0.0)
        res = srv.run()
        patient = srv.submit(spec_cls(np.ones((4, 1), np.float32),
                                      model="m", deadline=99.0,
                                      uid="patient"))
        outs[pkg] = (doomed.deadline, sorted(res), srv.stats.timed_out,
                     srv.tenant_stats["m"].timed_out, patient.deadline)
    assert outs["t"] == outs["j"] == (1.5, ["busy"], 1, 1, 99.0)


def test_legacy_engine_for_still_keyed_by_identity():
    engine_cache_clear()
    _ref, p = _params(6)
    a = engine_for(p, "torch")
    assert engine_for(p, "torch") is a
    b = engine_for(p, "torch", specialize=False)   # kwargs -> no cache
    assert b is not a and engine_for(p, "torch") is a
    engine_cache_clear()
