"""Sharded serving and elastic shrink/grow in the port against the JAX package.

The cases of ``tests/test_dist.py`` (and the sharded ones of
``test_scheduler.py``, ``test_obs.py`` and ``test_autotune.py``), with N
engine replicas on ``torch.device("cpu")`` (N up to 8, every shard on the
one CPU device) in place of the reference's 8 virtual XLA devices, at the
same small shapes (dim 96, block 32).  Weights cross with
``params_from_numpy``; every case runs both packages on the same seeded
numpy inputs.

* Exact against the reference: the elastic plan dicts (no action string of
  the reference names jit or shard_map, so none is reworded:
  ``REWORDED`` is empty), ``AutoscalePolicy.decide``, ``Heartbeats``,
  ``StragglerWatchdog``, least-loaded slot placement, admission order and
  admission times on the virtual clock, the mesh checks and the data-axis
  helpers.
* Bit for bit inside the port: the sharded engine and server against the
  port's single-device engine and server — both backends, fp32 and
  int8-csd, one-shot and chunked, through shrink, grow, a fault-plan shard
  death, two registry models in one pool and a publish mid-burst — at >= 2
  rows per shard (a one-row CPU product may round another way: C-port-1;
  the one-row cases use ``TOL``, as the reference's own tests do).
* Within ``TOL`` of the reference's single-device engine (``backend=
  "xla"``) and of its ``ShardedReservoirEngine(n_shards=1)``: float32 math
  in two frameworks (``tanh``, sum order) differs in the last bits.
* ``ridge_fit_sharded`` within ``RIDGE_TOL`` of the reference's under a
  one-device ``shard_map`` and of the port's ``ridge_fit``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import repro.dist as jdist
import repro.serve as jserve
from repro import obs as jobs
from repro.core import esn as jesn
from repro.core import ridge as jridge
from repro.launch import mesh as jmesh
from repro.parallel import sharding as jsharding
from repro.runtime import elastic as jelastic
from repro.runtime import faults as jfaults
from repro_torch import obs
from repro_torch.core import esn as tesn
from repro_torch.core.ridge import ridge_fit, ridge_fit_sharded
from repro_torch.dist import (DistributedReservoirServer,
                              ShardedContinuousBatcher,
                              ShardedReservoirEngine)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import DataMesh, local_devices, make_data_mesh
from repro_torch.parallel import sharding
from repro_torch.runtime import elastic, faults
from repro_torch.runtime.elastic import AutoscalePolicy
from repro_torch.runtime.faults import FaultEvent, FaultPlan
from repro_torch.serve import (AsyncReservoirServer, ModelRegistry,
                               ReservoirEngine, RolloutRequest, ServeStats,
                               SubmitSpec)
from repro_torch.serve.scheduler import ContinuousBatcher, QueuedRequest


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


TOL = 1e-5          # port vs reference: float32 in two frameworks
RIDGE_TOL = 1e-4    # sharded vs one-shot Gram sums, float32 eigensolvers
CPU = torch.device("cpu")
BACKENDS = ["torch", "cuda"]
MODES = ["fp32", "int8-csd"]
# reference action strings reworded in the port (those naming jit or
# shard_map): none, so every plan dict is compared whole
REWORDED: dict = {}
_PARAMS: dict = {}


@pytest.fixture(autouse=True)
def _reset_global_state():
    yield
    faults.install(None)
    jfaults.install(None)
    obs.disable()
    jobs.disable()


def _params(mode="fp32", seed=1, leak=0.7):
    """(reference, port) params: test_dist.py's reservoir with its fitted
    2-output readout, carried bit for bit."""
    key = (mode, seed, leak)
    if key not in _PARAMS:
        cfg = dict(reservoir_dim=96, element_sparsity=0.8, mode=mode,
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


def _mesh(n):
    return make_data_mesh(devices=[CPU] * n)


def _engine(port, n, **kw):
    return ShardedReservoirEngine(port, mesh=_mesh(n), stats=ServeStats(),
                                  **kw)


def _server(port, n, pool=None, **kw):
    eng = _engine(port, n, backend=kw.pop("backend", "auto"))
    kw.setdefault("chunk_time", 1.0)
    return DistributedReservoirServer(eng, stats=ServeStats(),
                                      devices=[CPU] * (pool or n), **kw)


def _jserver(ref, n_slots, **kw):
    """The reference's sharded server on its one CPU device."""
    eng = jdist.ShardedReservoirEngine(ref, n_shards=1, backend="xla",
                                       stats=jserve.ServeStats())
    return jdist.DistributedReservoirServer(
        eng, slots_per_shard=n_slots, chunk_time=1.0,
        stats=jserve.ServeStats(), **kw)


def _arrays(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, 1)).astype(np.float32) for t in lengths]


def _submit(srv, arrays, spec_cls=SubmitSpec, arrivals=None, **kw):
    for i, a in enumerate(arrays):
        srv.submit(spec_cls(a, uid=i, **kw),
                   arrival_time=0.0 if arrivals is None else arrivals[i])


def _same(a, b) -> None:
    for uid in b:
        np.testing.assert_array_equal(np.asarray(a[uid].output),
                                      np.asarray(b[uid].output))


def _near_ref(got, ref) -> None:
    for uid in ref:
        np.testing.assert_allclose(np.asarray(got[uid].output),
                                   np.asarray(ref[uid].output), atol=TOL)


# -- elastic plans and policies: exact ----------------------------------------
def test_no_reference_action_names_jit_or_shard_map():
    plans = [jelastic.shrink_serve_plan(4, 1), jelastic.grow_serve_plan(2, 2),
             jelastic.replan_after_failure(8, 2, 2)]
    words = " ".join(a for p in plans for a in p["actions"]).lower()
    assert "jit" not in words and "shard_map" not in words
    assert REWORDED == {}


def test_shrink_serve_plan_equals_reference():
    for n in range(1, 9):
        for failed in range(n + 1):
            assert elastic.shrink_serve_plan(n, failed) == \
                jelastic.shrink_serve_plan(n, failed), (n, failed)
    plan = elastic.shrink_serve_plan(8, 3)
    assert plan["survivors"] == plan["usable_devices"] == 5
    assert plan["mesh_shape"] == (5, 1)


@pytest.mark.parametrize("max_shards", [None, 4, 8])
def test_grow_serve_plan_equals_reference(max_shards):
    for n in range(1, 9):
        for added in range(5):
            assert elastic.grow_serve_plan(n, added, max_shards) == \
                jelastic.grow_serve_plan(n, added, max_shards)
    assert elastic.grow_serve_plan(6, 4, max_shards=8)["added"] == 2
    with pytest.raises(ValueError):
        elastic.grow_serve_plan(2, -1)
    with pytest.raises(AssertionError):
        jelastic.grow_serve_plan(2, -1)


@pytest.mark.parametrize("pods", [1, 2])
def test_plan_mesh_and_replan_equal_reference(pods):
    for n in range(1, 33):
        for mp in (1, 2, 4, 8, 16):
            assert elastic.plan_mesh(n * pods, mp, pods) == \
                jelastic.plan_mesh(n * pods, mp, pods)
            for failed in range(0, n * pods, 3):
                assert elastic.replan_after_failure(n * pods, failed, mp,
                                                    pods) == \
                    jelastic.replan_after_failure(n * pods, failed, mp, pods)


@pytest.mark.parametrize("policy", [
    dict(), dict(max_shards=8, grow_queue_per_slot=1.0),
    dict(min_shards=2, shrink_occupancy=0.25),
    dict(min_shards=1, max_shards=4, grow_queue_per_slot=0.5,
         shrink_occupancy=0.5, cooldown_steps=2)])
def test_autoscale_policy_decides_like_reference(policy):
    mine, ref = AutoscalePolicy(**policy), jelastic.AutoscalePolicy(**policy)
    for pending in (0, 1, 4, 8, 16, 20, 40):
        for n_shards in range(1, 10):
            n_slots = 4 * n_shards
            for live in range(0, n_slots + 1, 3):
                kw = dict(pending=pending, live=live, n_slots=n_slots,
                          n_shards=n_shards)
                assert mine.decide(**kw) == ref.decide(**kw), kw
    # the reference's own cases
    pol = AutoscalePolicy(max_shards=8, min_shards=2)
    assert pol.decide(pending=20, live=16, n_slots=16, n_shards=4) == 1
    assert pol.decide(pending=20, live=16, n_slots=16, n_shards=8) == 0
    assert pol.decide(pending=0, live=1, n_slots=16, n_shards=4) == -1
    assert pol.decide(pending=1, live=1, n_slots=16, n_shards=4) == 0
    assert pol.decide(pending=0, live=0, n_slots=16, n_shards=2) == 0
    assert pol.decide(pending=4, live=12, n_slots=16, n_shards=4) == 0


def test_heartbeats_like_reference():
    mine, ref = elastic.Heartbeats(timeout_s=5.0), \
        jelastic.Heartbeats(timeout_s=5.0)
    rng = np.random.default_rng(0)
    for t in range(40):
        host = f"h{int(rng.integers(0, 6))}"
        mine.beat(host, now=float(t))
        ref.beat(host, now=float(t))
        assert mine.failed(now=t + 3.0) == ref.failed(now=t + 3.0)
        assert mine.failed(now=t + 9.0) == ref.failed(now=t + 9.0)


def test_straggler_watchdog_like_reference():
    seen = {"port": [], "ref": []}
    mine = elastic.StragglerWatchdog(
        window=8, threshold=2.5,
        on_straggler=lambda s, d: seen["port"].append((s, d)))
    ref = jelastic.StragglerWatchdog(
        window=8, threshold=2.5,
        on_straggler=lambda s, d: seen["ref"].append((s, d)))
    rng = np.random.default_rng(1)
    for step in range(60):
        d = float(rng.exponential(1.0)) * (6.0 if step % 11 == 7 else 1.0)
        mine.record(step, d)
        ref.record(step, d)
        assert mine.median == ref.median
    assert mine.flagged == ref.flagged == seen["port"] == seen["ref"]
    assert mine.flagged


# -- ServeStats.merge (test_dist.py's TestServeStatsMerge) --------------------
def _stats_part(pkg, calls=2, steps=100, seconds=0.5, wait_max=0.1):
    s = pkg.ServeStats()
    for _ in range(calls):
        s.record_call(batch=4, steps=steps // calls // 4,
                      seconds=seconds / calls)
    s.record_enqueue()
    s.record_admission(wait_max)
    s.record_chunk(live_steps=steps // 2, total_steps=steps)
    return s


@pytest.mark.parametrize("labels", [None, ["shard0", "shard1"]])
def test_serve_stats_merge_like_reference(labels):
    import repro_torch.serve as tserve
    merged = {}
    for name, pkg in (("port", tserve), ("ref", jserve)):
        a = _stats_part(pkg, wait_max=0.1)
        b = _stats_part(pkg, calls=4, wait_max=0.7)
        a.record_timeout()
        merged[name] = pkg.ServeStats.merge([a, b], labels)
    m, j = merged["port"], merged["ref"]
    assert m.calls == j.calls == 6 and m.timed_out == j.timed_out == 1
    assert m.queue_wait_max_s == j.queue_wait_max_s == pytest.approx(0.7)
    assert m.latency_ewma_s == pytest.approx(j.latency_ewma_s)
    assert m.summary().keys() == j.summary().keys()
    assert m.render() == j.render()
    if labels:
        assert set(m.summary()["shards"]) == set(labels)
    assert ServeStats.merge([]).calls == 0


# -- the data mesh and the data-axis helpers ----------------------------------
def test_make_data_mesh_checks_like_reference():
    for call in (lambda m: m.make_data_mesh(0),
                 lambda m: m.make_data_mesh(2, devices=(
                     jax.devices() if m is jmesh else [CPU]))):
        with pytest.raises(ValueError) as mine:
            call(tmesh)
        with pytest.raises(ValueError) as ref:
            call(jmesh)
        assert str(mine.value) == str(ref.value)
    ref = jmesh.make_data_mesh(1)
    mesh = make_data_mesh(1, devices=[CPU, CPU])
    assert mesh.axis_names == ref.axis_names == ("data",)
    assert mesh.shape == dict(ref.shape) == {"data": 1}
    assert mesh.devices == (CPU,)


def test_data_mesh_repeats_a_device():
    mesh = DataMesh([CPU] * 4)
    assert mesh.shape == {"data": 4}
    assert mesh.devices == (CPU,) * 4
    with pytest.raises(ValueError):
        DataMesh(())


def test_local_devices():
    assert local_devices("cpu") == [CPU]
    if torch.cuda.is_available():
        assert local_devices() == [torch.device("cuda", i) for i in
                                   range(torch.cuda.device_count())]
    else:
        with pytest.raises(RuntimeError):
            local_devices()
        with pytest.raises(RuntimeError):
            make_data_mesh(1)


@dataclasses.dataclass
class _StubMesh:
    axis_names: tuple
    shape: dict


@pytest.mark.parametrize("axes", [("data",), ("data", "model"),
                                  ("pod", "data", "model"), ("model",)])
def test_sharding_helpers_like_reference(axes):
    mesh = _StubMesh(axes, {a: i + 2 for i, a in enumerate(axes)})
    assert sharding.data_axis_names(mesh) == \
        jsharding.data_axis_names(mesh)
    assert sharding.data_axis_size(mesh) == jsharding.data_axis_size(mesh)
    if sharding.data_axis_names(mesh):
        assert sharding.batch_spec(mesh) == tuple(jsharding.batch_spec(mesh))
    ref = jmesh.make_data_mesh(1)
    assert sharding.batch_spec(_mesh(3)) == tuple(jsharding.batch_spec(ref))
    assert sharding.data_axis_size(_mesh(3)) == 3


# -- ridge_fit_sharded --------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_ridge_fit_sharded_matches_reference(n_shards):
    from jax.experimental.shard_map import shard_map
    rng = np.random.default_rng(n_shards)
    x = rng.standard_normal((400, 24)).astype(np.float32)
    y = (x @ rng.standard_normal((24, 3))
         + 0.1 * rng.standard_normal((400, 3))).astype(np.float32)
    lam = 1e-2
    fit = jax.jit(shard_map(
        lambda a, b: jridge.ridge_fit_sharded(a, b, lam, "data"),
        mesh=jmesh.make_data_mesh(1), in_specs=(P("data"), P("data")),
        out_specs=P(), check_rep=False))
    want = np.asarray(fit(jnp.asarray(x), jnp.asarray(y)))
    xs = [torch.as_tensor(c) for c in np.array_split(x, n_shards)]
    ys = [torch.as_tensor(c) for c in np.array_split(y, n_shards)]
    got = ridge_fit_sharded(xs, ys, lam, "data")
    one = ridge_fit(torch.as_tensor(x), torch.as_tensor(y), lam=lam)
    assert got.shape == (24, 3) and got.device == CPU
    np.testing.assert_allclose(got.numpy(), want, atol=RIDGE_TOL)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=RIDGE_TOL)
    with pytest.raises(ValueError):
        ridge_fit_sharded(xs, ys[:-1] if n_shards > 1 else [], lam, "data")


# -- engines ------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_single_shard_bit_identical(backend):
    ref, port = _params()
    single = ReservoirEngine(port, backend=backend, stats=ServeStats())
    sharded = _engine(port, 1, backend=backend)
    jsharded = jdist.ShardedReservoirEngine(ref, n_shards=1, backend="xla",
                                            stats=jserve.ServeStats())
    u = np.random.default_rng(0).standard_normal((4, 12, 1)).astype(
        np.float32)
    got = sharded.rollout(torch.as_tensor(u))
    assert torch.equal(got, single.rollout(torch.as_tensor(u)))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jsharded.rollout(jnp.asarray(u))), atol=TOL)
    z = torch.zeros((4, 96))
    pr_s, xf_s = sharded.run_segment(torch.as_tensor(u), z)
    pr_1, xf_1 = single.run_segment(torch.as_tensor(u), z)
    assert torch.equal(pr_s, pr_1) and torch.equal(xf_s, xf_1)
    jp, jx = jsharded.run_segment(jnp.asarray(u), jnp.zeros((4, 96)))
    np.testing.assert_allclose(pr_s.numpy(), np.asarray(jp), atol=TOL)
    np.testing.assert_allclose(xf_s.numpy(), np.asarray(jx), atol=TOL)


def test_serve_api_and_padding_accounting():
    _ref, port = _params()
    sharded = _engine(port, 1)
    specs = [SubmitSpec(a, uid=i) for i, a in
             enumerate(_arrays([5, 9, 12], seed=2))]
    res = sharded.submit_many(specs)
    assert set(res) == {0, 1, 2} and res[1].output.shape == (9, 2)
    assert sharded.stats.steps_real > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_eight_shards_one_shot_and_chunked(backend, mode):
    """8 shards x 2 rows == the single-device engine bit for bit (states,
    fused-readout predictions, a chunked carry), within TOL of the
    reference's."""
    ref, port = _params(mode)
    single = ReservoirEngine(port, backend=backend, stats=ServeStats())
    sharded = _engine(port, 8, backend=backend)
    assert sharded.n_shards == 8 and sharded.backend == backend
    jsingle = jserve.ReservoirEngine(ref, backend="xla",
                                     stats=jserve.ServeStats())
    u = np.random.default_rng(4).standard_normal((16, 12, 1)).astype(
        np.float32)
    ut = torch.as_tensor(u)
    states, preds = sharded.rollout(ut), sharded.predictions(ut)
    assert torch.equal(states, single.rollout(ut))
    assert torch.equal(preds, single.predictions(ut))
    np.testing.assert_allclose(states.numpy(), np.asarray(
        jsingle.rollout(jnp.asarray(u))), atol=TOL)
    np.testing.assert_allclose(preds.numpy(), np.asarray(
        jsingle.predictions(jnp.asarray(u))), atol=TOL)
    p1, xf = sharded.run_segment(ut[:, :6], torch.zeros((16, 96)))
    p2 = sharded.predictions(ut[:, 6:], x0=xf)
    assert torch.equal(torch.cat([p1, p2], dim=1), preds)


def test_ragged_batch_pads_to_shard_multiple():
    _ref, port = _params()
    single = ReservoirEngine(port, stats=ServeStats())
    sharded = _engine(port, 8)
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (5, 10, 1)).astype(np.float32))
    out = sharded.predictions(u)
    assert out.shape == (5, 10, 2)              # padding rows trimmed
    # one row per shard here: a CPU product may round another way
    # (C-port-1), so within TOL; >= 2 rows per shard below is exact
    np.testing.assert_allclose(out.numpy(), single.predictions(u).numpy(),
                               atol=TOL)
    # padded rows counted as executed (8 rows ran for 5 real)
    assert sharded.stats.sequences == 8
    assert sharded.stats.steps_real == 50
    assert sharded.stats.steps_padded == 80
    # 13 rows over 4 shards pad to 16: 4 rows per shard, exact
    four = _engine(port, 4)
    u13 = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (13, 10, 1)).astype(np.float32))
    x0 = torch.as_tensor(0.3 * np.random.default_rng(7).standard_normal(
        (13, 96)).astype(np.float32))
    got, xf = four.run_segment(u13, x0)
    want, xf1 = single.run_segment(u13, x0)
    assert got.shape == (13, 10, 2)
    assert torch.equal(got, want) and torch.equal(xf, xf1)


@pytest.mark.parametrize("batch", [16, 13])
@pytest.mark.parametrize("backend", BACKENDS)
def test_donated_carry_written_in_place(backend, batch):
    _ref, port = _params("int8-csd")
    single = ReservoirEngine(port, backend=backend, stats=ServeStats())
    sharded = _engine(port, 4, backend=backend)
    rng = np.random.default_rng(8)
    u = torch.as_tensor(rng.standard_normal((batch, 8, 1)).astype(
        np.float32))
    x0 = torch.as_tensor(0.3 * rng.standard_normal((batch, 96)).astype(
        np.float32))
    want, want_xf = single.run_segment(u, x0.clone())
    carry = x0.clone()
    got, xf = sharded.run_segment(u, carry, donate_state=True)
    assert xf.data_ptr() == carry.data_ptr()
    assert torch.equal(got, want) and torch.equal(carry, want_xf)


def test_left_out_shards_make_no_launch():
    """``run_segment(shards=...)`` launches only the named shards; the
    others' rows come back as zero outputs and an unchanged carry."""
    _ref, port = _params()
    sharded = _engine(port, 4)
    calls = []
    real = ReservoirEngine._dispatch

    def spy(eng, u, *a, **k):
        calls.append(u.shape[0])
        return real(eng, u, *a, **k)

    u = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (8, 6, 1)).astype(np.float32))
    x0 = torch.as_tensor(0.3 * np.random.default_rng(10).standard_normal(
        (8, 96)).astype(np.float32))
    full, full_xf = sharded.run_segment(u, x0)
    ReservoirEngine._dispatch = spy
    try:
        part, part_xf = sharded.run_segment(u, x0, shards=[3, 1])
    finally:
        ReservoirEngine._dispatch = real
    assert calls == [2, 2]
    live = torch.zeros(8, dtype=torch.bool)
    live[[2, 3, 6, 7]] = True
    assert torch.equal(part[live], full[live])
    assert not part[~live].any()
    assert torch.equal(part_xf[live], full_xf[live])
    assert torch.equal(part_xf[~live], x0[~live])


# -- the sharded batcher and server -------------------------------------------
def test_least_loaded_placement_like_reference():
    """The port's slot choice equals the reference's ``_free_slot`` over
    the same random admit/retire sequence on an 8 x 2 pool."""
    _ref, port = _params()
    cb = ShardedContinuousBatcher(_engine(port, 8), slots_per_shard=2,
                                  chunk_steps=4)
    stub = type("Stub", (), {})()
    stub.n_shards, stub.slots_per_shard = 8, 2
    stub.shard_of = lambda s: jdist.ShardedContinuousBatcher.shard_of(
        stub, s)
    stub.free_slots_by_shard = \
        lambda: jdist.ShardedContinuousBatcher.free_slots_by_shard(stub)
    rng = np.random.default_rng(11)
    seated = 0
    for i in range(200):
        stub._slots = list(cb._slots)
        if cb.has_free_slot() and (rng.random() < 0.6 or seated == 0):
            want = jdist.ShardedContinuousBatcher._free_slot(stub)
            slot = cb.admit(QueuedRequest(RolloutRequest(
                uid=i, inputs=np.ones((4, 1), np.float32))))
            assert slot == want
            seated += 1
        elif seated:
            busy = [k for k, q in enumerate(cb._slots) if q is not None]
            cb._slots[int(rng.choice(busy))] = None
            seated -= 1


def test_least_loaded_admission_spreads_shards():
    _ref, port = _params()
    cb = ShardedContinuousBatcher(_engine(port, 8), slots_per_shard=2,
                                  chunk_steps=4)
    for i in range(8):
        cb.admit(QueuedRequest(RolloutRequest(
            uid=i, inputs=np.ones((4, 1), np.float32))))
    # one request per shard before any shard takes a second
    assert cb.free_slots_by_shard() == [1] * 8
    assert [s.admitted for s in cb.shard_stats] == [1] * 8
    assert [cb.shard_of(i) for i in range(16)] == \
        [i // 2 for i in range(16)]


@pytest.mark.parametrize("zero_copy", [False, True])
def test_admission_order_and_answers_like_reference(zero_copy):
    """4 shards x 2 slots against the reference's one-device 8-slot
    sharded pool and the port's single-device 8-slot server: the same
    admission order and times on the virtual clock; answers bit for bit
    against the port's single-device server, within TOL of the
    reference's."""
    ref, port = _params()
    arrays = _arrays([5, 17, 30, 9, 12, 23, 8, 40, 11, 16], seed=6)
    arrivals = [0.25 * i for i in range(10)]
    srv = _server(port, 4, slots_per_shard=2, chunk_steps=8,
                  zero_copy=zero_copy)
    _submit(srv, arrays, arrivals=arrivals)
    res = srv.run()
    single = AsyncReservoirServer(ReservoirEngine(port), n_slots=8,
                                  chunk_steps=8, chunk_time=1.0,
                                  stats=ServeStats(), zero_copy=zero_copy)
    _submit(single, arrays, arrivals=arrivals)
    one = single.run()
    jsrv = _jserver(ref, 8, chunk_steps=8)
    seats = []
    real_admit = jsrv.batcher.admit
    jsrv.batcher.admit = lambda q: (seats.append(q.uid), real_admit(q))[1]
    _submit(jsrv, arrays, jserve.SubmitSpec, arrivals)
    jres = jsrv.run()
    assert srv.admission_order == single.admission_order == seats
    assert len(res) == 10 and srv.stats.completed == 10
    for uid in res:
        for key in ("arrival_time", "admit_time", "first_output_time",
                    "finish_time"):
            assert res[uid].timings[key] == jres[uid].timings[key]
    _same(res, one)
    _near_ref(res, jres)
    merged = srv.shard_summary()
    assert merged.completed == 10 and len(merged.shards) == 4


def test_one_launch_per_shard_with_live_slots():
    """Every chunk calls the rollout once per shard that holds a live
    slot of that chunk, and never for an idle shard."""
    _ref, port = _params()
    srv = _server(port, 4, slots_per_shard=2, chunk_steps=4)
    calls = []
    real = ReservoirEngine._dispatch

    def spy(eng, u, *a, **k):
        calls.append(u.shape[0])
        return real(eng, u, *a, **k)

    _submit(srv, _arrays([4, 12, 20, 8, 8], seed=12))
    ReservoirEngine._dispatch = spy
    expected = 0
    try:
        while True:
            chunks = srv.stats.chunks
            if not srv.step():
                break
            if srv.stats.chunks > chunks:
                expected += len({srv.batcher.shard_of(s)
                                 for s in srv.batcher.last_take})
    finally:
        ReservoirEngine._dispatch = real
    assert len(calls) == expected and set(calls) == {2}
    assert expected < 4 * srv.stats.chunks      # idle shards skipped


def test_distributed_server_matches_engine():
    ref, port = _params()
    single = ReservoirEngine(port, stats=ServeStats())
    srv = _server(port, 1, slots_per_shard=3, chunk_steps=8)
    arrays = _arrays([5, 17, 30, 9, 12, 23], seed=3)
    _submit(srv, arrays, arrivals=[0.5 * i for i in range(6)])
    res = srv.run()
    jsrv = _jserver(ref, 3, chunk_steps=8)
    _submit(jsrv, arrays, jserve.SubmitSpec, [0.5 * i for i in range(6)])
    jres = jsrv.run()
    for i, a in enumerate(arrays):
        # a one-shot request is one row (C-port-1): within TOL
        np.testing.assert_allclose(res[i].output, single.predictions(
            torch.as_tensor(a)).numpy(), atol=TOL)
    _near_ref(res, jres)
    merged = srv.shard_summary()
    assert merged.completed == 6 and merged.shards is not None
    assert "shard0" in merged.summary()["shards"]


def test_shard_loss_loses_no_request():
    ref, port = _params()
    single = ReservoirEngine(port, stats=ServeStats())
    srv = _server(port, 8, slots_per_shard=1, chunk_steps=4)
    arrays = _arrays([16] * 12, seed=7)
    _submit(srv, arrays)
    srv.step()                                   # 8 in flight, mid-rollout
    assert srv.batcher.live == 8
    plan = srv.shrink(failed=3)
    assert plan == {**jelastic.shrink_serve_plan(8, 3),
                    "n_shards_before": 8, "n_shards_after": 5,
                    "readmitted": 8}
    assert srv.n_shards == 5 and srv.batcher.n_shards == 5
    assert srv.readmitted == 8 and srv.reshards == 1
    assert srv.engine.mesh.devices == (CPU,) * 5
    res = srv.run()
    assert len(res) == 12                        # nothing lost
    # re-admissions must not double-count queue telemetry
    assert srv.stats.admitted == srv.stats.enqueued == 12
    assert srv.stats.completed == 12
    merged = srv.shard_summary()
    assert merged.completed == 12
    assert any(label.startswith("epoch0/") for label in merged.shards)
    assert any(label.startswith("epoch1/") for label in merged.shards)
    jsrv = _jserver(ref, 8, chunk_steps=4)
    _submit(jsrv, arrays, jserve.SubmitSpec)
    jres = jsrv.run()
    for i, a in enumerate(arrays):
        # one slot per shard: one-row products (C-port-1), within TOL
        np.testing.assert_allclose(res[i].output, single.predictions(
            torch.as_tensor(a)).numpy(), atol=TOL)
    _near_ref(res, jres)


def test_shrink_resume_is_bit_exact_when_shapes_allow():
    _ref, port = _params()
    u = np.random.default_rng(8).standard_normal((8, 1)).astype(np.float32)
    outs = []
    for disturb in (False, True):
        srv = _server(port, 8, slots_per_shard=2, chunk_steps=4)
        srv.submit(SubmitSpec(u, uid="a"), arrival_time=0.0)
        srv.step()
        if disturb:
            srv.shrink(failed=4)
        outs.append(srv.run()["a"].output)
    assert outs[1].shape == (8, 2)
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("zero_copy", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_shrink_grow_round_trip_bit_identical(backend, zero_copy):
    """A pool shrunk then regrown under traffic serves every request bit
    for bit as an undisturbed sharded pool and the single-device server
    do (2 slots per shard), within TOL of the reference's."""
    ref, port = _params()
    arrays = _arrays([12] * 12, seed=9)

    def serve(disturb):
        srv = _server(port, 4, slots_per_shard=2, chunk_steps=4,
                      backend=backend, zero_copy=zero_copy)
        _submit(srv, arrays)
        if disturb:
            srv.step()                           # 8 in flight
            srv.shrink(failed=2)
            srv.step()                           # a chunk at width 2
            plan = srv.grow(2)
            assert plan["n_shards_after"] == 4 and srv.n_shards == 4
            assert plan["readmitted"] == 4      # the width-2 pool's slots
            assert srv.grows == 1 and srv.reshards == 1
        return srv.run(), srv

    undisturbed, _ = serve(False)
    res, srv = serve(True)
    assert len(res) == 12 and srv.stats.completed == 12
    assert srv.stats.admitted == srv.stats.enqueued == 12
    _same(res, undisturbed)
    single = AsyncReservoirServer(ReservoirEngine(port, backend=backend),
                                  n_slots=8, chunk_steps=4, chunk_time=1.0,
                                  stats=ServeStats())
    _submit(single, arrays)
    _same(res, single.run())
    jsrv = _jserver(ref, 8, chunk_steps=4)
    _submit(jsrv, arrays, jserve.SubmitSpec)
    _near_ref(res, jsrv.run())


def test_grow_rebalances_subpools():
    _ref, port = _params()
    srv = _server(port, 2, pool=4, slots_per_shard=2, chunk_steps=4)
    _submit(srv, _arrays([16] * 12, seed=10))
    srv.step()
    assert srv.batcher.live == 4
    srv.grow(2)
    assert srv.n_shards == 4 and srv.batcher.n_slots == 8
    srv.step()
    # every shard of the widened pool holds seated work
    assert all(f < srv.slots_per_shard
               for f in srv.batcher.free_slots_by_shard())
    res = srv.run()
    assert len(res) == 12 and srv.stats.completed == 12
    assert srv.shard_summary().completed == 12


def test_grow_is_capped_by_the_device_pool():
    _ref, port = _params()
    srv = _server(port, 2, pool=3, slots_per_shard=2, chunk_steps=4)
    plan = srv.grow(4)
    assert plan["n_shards_after"] == 3 and srv.n_shards == 3
    again = srv.grow(1)
    assert again == {**jelastic.grow_serve_plan(3, 1, max_shards=3),
                     "readmitted": 0}
    assert srv.grows == 1
    with pytest.raises(ValueError):
        DistributedReservoirServer(_engine(port, 2),
                                   devices=[CPU])         # mesh not a prefix


def test_fault_plan_shard_death_recovers_through_shrink():
    """A shard death scheduled by the fault plan is detected at the next
    step and taken through the shrink path (zero loss); the autoscale
    policy grows the pool back under the remaining backlog; every answer
    bit for bit as the undisturbed run."""
    ref, port = _params()
    plan = FaultPlan([FaultEvent("shard_loss", at=2.0, shard=1)])
    arrays = _arrays([12] * 20, seed=11)
    srv = _server(port, 4, slots_per_shard=2, chunk_steps=4,
                  fault_plan=plan, autoscale=AutoscalePolicy(
                      min_shards=1, max_shards=4, cooldown_steps=2))
    _submit(srv, arrays)
    res = srv.run()
    assert plan.injected.get("shard_loss") == 1
    assert srv.reshards >= 1 and srv.grows >= 1
    assert len(res) == 20 and srv.stats.completed == 20
    undisturbed = _server(port, 4, slots_per_shard=2, chunk_steps=4)
    _submit(undisturbed, arrays)
    _same(res, undisturbed.run())
    assert srv.readmitted > 0
    # the reference's undisturbed run (its one-device pool cannot lose a
    # shard)
    jsrv = _jserver(ref, 8, chunk_steps=4)
    _submit(jsrv, arrays, jserve.SubmitSpec)
    _near_ref(res, jsrv.run())


def test_two_models_share_sharded_pool_bit_exact():
    """Two registry models interleaved through one sharded FIFO, each bit
    for bit as its own single-tenant sharded serve at the same pool
    shape, within TOL of the reference's."""
    (ref_a, pa), (ref_b, pb) = _params(seed=1), _params(seed=2, leak=0.55)
    arrays = _arrays([16] * 8, seed=12)

    def serve(models):
        reg = ModelRegistry()
        reg.register("A", pa)
        reg.register("B", pb)
        srv = _server(pa, 4, slots_per_shard=2, chunk_steps=8,
                      registry=reg)
        for i, a in enumerate(arrays):
            srv.submit(SubmitSpec(a, model=models(i), uid=i),
                       arrival_time=0.0)
        return srv.run(), srv

    mixed, srv = serve(lambda i: "AB"[i % 2])
    only_a, _ = serve(lambda i: "A")
    only_b, _ = serve(lambda i: "B")
    for i in range(8):
        want = (only_a if i % 2 == 0 else only_b)[i]
        np.testing.assert_array_equal(mixed[i].output, want.output)
    ts = srv.tenant_summary()
    assert ts.shards["A"].completed == ts.shards["B"].completed == 4
    jreg = jserve.ModelRegistry()
    jreg.register("A", ref_a)
    jreg.register("B", ref_b)
    jsrv = _jserver(ref_a, 8, chunk_steps=8, registry=jreg)
    for i, a in enumerate(arrays):
        jsrv.submit(jserve.SubmitSpec(a, model="AB"[i % 2], uid=i),
                    arrival_time=0.0)
    _near_ref(mixed, jsrv.run())


def test_publish_swaps_on_sharded_server():
    (_r1, p1), (_r2, p2) = _params(seed=3), _params(seed=4)
    reg = ModelRegistry()
    reg.register("m", p1)
    srv = _server(p1, 4, slots_per_shard=2, chunk_steps=4, registry=reg)
    u = np.random.default_rng(5).standard_normal((12, 1)).astype(np.float32)
    pre = srv.submit(SubmitSpec(u, model="m", uid="pre"), arrival_time=0.0)
    srv.step()                                   # "pre" pinned to v1
    plan = reg.publish("m", p2)
    assert plan["version"] == 2
    post = srv.submit(SubmitSpec(u, model="m", uid="post"))
    res = srv.run()
    assert pre.pinned_version == 1 and post.pinned_version == 2
    assert srv.stats.timed_out == 0 and len(res) == 2
    batch = torch.as_tensor(np.broadcast_to(u[None], (8,) + u.shape).copy())
    for uid, version in (("pre", 1), ("post", 2)):
        eng = srv._tenant_engine("m", version)
        assert isinstance(eng, ShardedReservoirEngine)
        assert eng.mesh == srv.engine.mesh and eng.tenant == ("m", version)
        np.testing.assert_array_equal(res[uid].output,
                                      eng.predictions(batch)[0].numpy())


# -- the sharded cases of test_scheduler.py, test_obs.py, test_autotune.py ----
def test_sharded_server_zero_copy_passthrough():
    _ref, port = _params()
    outs = {}
    for zc in (False, True):
        srv = _server(port, 2, slots_per_shard=2, chunk_steps=4,
                      zero_copy=zc)
        assert srv.batcher.zero_copy is zc
        _submit(srv, _arrays([10, 6, 7], seed=9))
        srv.step()
        srv.shrink(1)
        assert srv.batcher.zero_copy is zc       # carried across the rebuild
        outs[zc] = srv.run()
    assert set(outs[True]) == set(outs[False])
    _same(outs[True], outs[False])


@pytest.mark.parametrize("n_shards", [1, 2])
def test_shrink_snapshot_survives_host_input_mutation(n_shards):
    """A rebuild carries a sequence's remaining inputs from the
    device-resident lane, not the caller's buffer."""
    _ref, port = _params()
    inputs = np.random.default_rng(11).standard_normal((24, 1)).astype(
        np.float32)

    def serve(mutate):
        buf = inputs.copy()
        srv = _server(port, n_shards, slots_per_shard=2, chunk_steps=4,
                      zero_copy=True)
        srv.submit(SubmitSpec(buf, uid="m"))
        srv.step()                               # one chunk consumed
        if mutate:
            buf[:] = 999.0                       # host buffer is dead
        srv.shrink(n_shards - 1)                 # snapshot + re-admission
        return srv.run()["m"].output

    np.testing.assert_array_equal(serve(False), serve(True))


def test_sharded_server_merged_percentiles():
    """Queue-wait/ttfp series carry a shard label per shard and merge
    into one exact histogram, with the reference's counts and
    percentiles."""
    ref, port = _params()
    arrays = _arrays([10] * 5, seed=3)
    arrivals = [0.1 * i for i in range(5)]
    hists = {}
    for name, make, mod, spec in (
            ("port", lambda: _server(port, 3, slots_per_shard=1,
                                     chunk_steps=8), obs, SubmitSpec),
            ("ref", lambda: _jserver(ref, 3, chunk_steps=8), jobs,
             jserve.SubmitSpec)):
        mod.configure()
        srv = make()
        _submit(srv, arrays, spec, arrivals)
        srv.run()
        hists[name] = mod.metrics().histogram("queue_wait_seconds")
        hists[name + "_ttfp"] = mod.metrics().histogram("ttfp_seconds")
        mod.disable()
    qw = hists["port"]
    assert qw.count() == hists["ref"].count() == 5
    assert hists["port_ttfp"].count() == 5
    shards = set()
    for key, data in qw.series.items():
        labels = dict(key)
        assert "shard" in labels
        shards.add(labels["shard"])
    assert shards == {"0", "1", "2"}
    assert sum(d.total for d in qw.series.values()) == 5
    for p in (50, 99, 99.9):
        assert qw.percentile(p) == hists["ref"].percentile(p) > 0.0


def test_sharded_engine_inherits_tuned_schedule():
    from repro_torch.plan import plan_for, resolve_schedule
    _ref, port = _params("int8-csd", seed=11)
    tuned = resolve_schedule(plan_for(port.w), "int8", device=CPU)
    eng = _engine(port, 2)
    assert eng.schedule == tuned.schedule
    assert eng.backend == tuned.schedule.backend
    assert list(eng._replicas.values()) == [eng]  # one device, one replica
    sib = eng.like()
    assert sib.schedule == eng.schedule and sib.mesh == eng.mesh
    assert sib.vmem_budget == eng.vmem_budget
    wider = eng.like(mesh=_mesh(4))
    assert wider.n_shards == 4 and wider.schedule == eng.schedule


# -- the scheduler hooks on the single-device pool ----------------------------
@pytest.mark.parametrize("zero_copy", [False, True])
def test_single_device_batcher_hooks(zero_copy):
    _ref, port = _params()
    eng = ReservoirEngine(port)
    calls = []
    real = eng._dispatch
    eng._dispatch = lambda *a, **k: (calls.append(1), real(*a, **k))[1]
    cold = ContinuousBatcher(eng, n_slots=3, chunk_steps=4, warm=False,
                             zero_copy=zero_copy)
    assert calls == []                            # warm=False: no call
    cb = ContinuousBatcher(eng, n_slots=3, chunk_steps=4,
                           zero_copy=zero_copy)
    assert len(calls) == 1 and cold.shard_of(0) is None
    arrays = _arrays([6, 3], seed=13)
    for i, a in enumerate(arrays):
        assert cb.admit(QueuedRequest(RolloutRequest(uid=i, inputs=a),
                                      model="m" if i else None)) == i
    cb.run_chunk()
    assert cb.last_take == {0: 4, 1: 3}
    assert cb.last_retired_slots == [1]
    assert cb.last_models == {0: None, 1: "m"}
    np.testing.assert_array_equal(cb.remaining_inputs(0), arrays[0][4:])
    assert [c.shape for c in cb.chunk_outputs(0)] == [(4, 2)]
    assert QueuedRequest(RolloutRequest(uid=0, inputs=arrays[0])).requeued \
        is False
