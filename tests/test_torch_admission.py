"""Admission control in the port against the JAX package's.

The cases of ``tests/test_admission.py``, each run through the reference
(``backend="xla"``) and the port (``backend="torch"`` and ``"cuda"``, which
runs the kernels' twins on the CPU) on the same seeded inputs, with the
weights carried by ``params_from_numpy``.  Rejection and shed decisions,
their reasons, retry-after hints and counters must be identical; outputs
of admitted requests agree with the reference within ``TOL`` and, inside
the port, equal an unpoliced run bit for bit.  Most servers here run a
fixed ``chunk_time`` (the virtual clock); without one, before any chunk
has run, both packages price a chunk with their autotuner's cost model,
and the estimates (``RTOL``) and the decisions built on them agree.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.serve as jserve
from repro.core import esn as jesn
from repro.serve import admission as jadm
from repro_torch.core import esn as tesn
from repro_torch.serve import (AsyncReservoirServer, BoundedQueuePolicy,
                               CompositePolicy, DeadlineShedPolicy,
                               ModelRegistry, ReservoirEngine, Rejection,
                               ServeStats, SubmitSpec, TenantFairnessPolicy,
                               default_policy)
from repro_torch.serve import admission as tadm


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
RTOL = 1e-12
BACKENDS = ["torch", "cuda"]
_PARAMS = {}


def _params(seed=1, dim=96):
    """(reference params, port params): test_admission.py's reservoir with
    a ridge-fitted 2-output readout, carried bit for bit."""
    if (seed, dim) not in _PARAMS:
        cfg = dict(reservoir_dim=dim, element_sparsity=0.8, mode="fp32",
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
        _PARAMS[(seed, dim)] = (ref, port)
    return _PARAMS[(seed, dim)]


def _pair(backend, *, admission=None, j_admission=None, **kw):
    """(reference server, port server) over the same weights."""
    ref, port = _params()
    kw.setdefault("chunk_time", 1.0)
    j = jserve.AsyncReservoirServer(
        jserve.ReservoirEngine(ref, backend="xla", stats=jserve.ServeStats()),
        stats=jserve.ServeStats(), admission=j_admission, **kw)
    t = AsyncReservoirServer(
        ReservoirEngine(port, backend=backend, stats=ServeStats()),
        stats=ServeStats(), admission=admission, **kw)
    return j, t


def _specs(lengths, seed=0, deadlines=None):
    """The same request list for both packages: (reference, port)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((n, 1)).astype(np.float32)
              for n in lengths]
    dl = deadlines or [None] * len(arrays)
    return ([jserve.SubmitSpec(a, uid=i, deadline=d)
             for i, (a, d) in enumerate(zip(arrays, dl))],
            [SubmitSpec(a, uid=i, deadline=d)
             for i, (a, d) in enumerate(zip(arrays, dl))])


def _verdicts(outcomes) -> list:
    """(reason, retry_after_s) per submission; None when it queued."""
    return [(r.timings["reason"], r.timings["retry_after_s"])
            if getattr(r, "status", None) == "rejected" else None
            for r in outcomes]


def _counters(st) -> tuple:
    return (st.enqueued, st.rejected, st.shed, st.timed_out, st.completed)


# -- fakes for the pure policy math (duck-typed for both packages) -----------
class _FakeQ:
    def __init__(self, model, length=8):
        self.model = model
        self.length = length
        self.deadline = None
        self.arrival_time = 0.0


class _FakeServer:
    def __init__(self, seated, queued, n_slots):
        class B:
            pass
        self.batcher = B()
        self.batcher.n_slots = n_slots
        self.batcher.chunk_steps = 4
        self.batcher._slots = list(seated) + [None] * (n_slots - len(seated))
        self.batcher._pos = [0] * n_slots
        self._queue = [(0.0, i, q) for i, q in enumerate(queued)]
        self.chunk_time = 1.0

    @property
    def pending(self):
        return len(self._queue)


@pytest.mark.parametrize("queued", [0, 2, 8, 13])
def test_estimators_match_reference(queued):
    srv = _FakeServer([_FakeQ(None, 5)], [_FakeQ(None, 8)] * queued,
                      n_slots=2)
    assert tadm.estimate_chunk_seconds(srv) == \
        jadm.estimate_chunk_seconds(srv) == 1.0
    assert tadm.estimate_queue_delay(srv) == jadm.estimate_queue_delay(srv)


def test_chunk_estimate_before_any_measurement():
    """No chunk_time and nothing measured: the port prices the pool's
    chunk with its cost model as the reference does (the "auto" engines'
    tuned schedules; an explicit backend leaves no batch tile to price,
    and both packages take the 1e-3 fallback); once a chunk ran, the
    measured EWMA decides, as in the reference."""
    ref, port = _params()
    for j_backend, t_backend in (("auto", "auto"), ("xla", "torch")):
        j = jserve.AsyncReservoirServer(
            jserve.ReservoirEngine(ref, backend=j_backend),
            n_slots=2, chunk_steps=8)
        # the server shares the engine's stats, where the EWMA lands
        srv = AsyncReservoirServer(ReservoirEngine(port, backend=t_backend),
                                   n_slots=2, chunk_steps=8)
        want = jadm.estimate_chunk_seconds(j)
        assert tadm.estimate_chunk_seconds(srv) == pytest.approx(
            want, rel=RTOL, abs=0.0)
        if t_backend == "auto":
            assert srv.batcher.engine.backend == "torch"
            assert want != 1e-3
        else:
            assert want == 1e-3
    srv.submit(SubmitSpec(np.ones((8, 1), np.float32)))
    srv.run()
    assert tadm.estimate_chunk_seconds(srv) == srv.stats.latency_ewma_s > 0


@pytest.mark.parametrize("n_slots,chunk_steps", [(1, 4), (2, 8), (4, 32)])
def test_deadline_shed_on_the_cost_model_like_reference(n_slots,
                                                        chunk_steps):
    """No chunk_time: the shed decisions and retry hints of "auto"
    engines rest on the cost model's chunk estimate, in both packages.
    Deadlines straddle the estimated delay, so some requests are shed
    and some queue."""
    ref, port = _params()
    j = jserve.AsyncReservoirServer(
        jserve.ReservoirEngine(ref), n_slots=n_slots,
        chunk_steps=chunk_steps, stats=jserve.ServeStats(),
        admission=jadm.DeadlineShedPolicy())
    t = AsyncReservoirServer(
        ReservoirEngine(port), n_slots=n_slots, chunk_steps=chunk_steps,
        stats=ServeStats(), admission=DeadlineShedPolicy())
    chunk = jadm.estimate_chunk_seconds(j)
    assert tadm.estimate_chunk_seconds(t) == pytest.approx(
        chunk, rel=RTOL, abs=0.0)
    verdicts = {}
    for name, srv, spec_cls in (("j", j, jserve.SubmitSpec),
                                ("t", t, SubmitSpec)):
        out = [srv.submit(spec_cls(np.ones((24, 1), np.float32),
                                   uid=f"long{i}"), arrival_time=0.0)
               for i in range(n_slots + 1)]
        for k, factor in enumerate((0.5, 1.5, 2.5, 4.0, 40.0)):
            out.append(srv.submit(spec_cls(
                np.ones((4, 1), np.float32), uid=f"d{k}",
                deadline=factor * chunk), arrival_time=0.0))
        verdicts[name] = _verdicts(out)
    jv, tv = verdicts["j"], verdicts["t"]
    assert [v is None for v in tv] == [v is None for v in jv]
    assert any(v is not None for v in tv) and tv[-1] is None
    for a, b in zip(tv, jv):
        if a is not None:
            assert a[0] == b[0] == "deadline_unmeetable"
            assert a[1] == pytest.approx(b[1], rel=RTOL, abs=0.0)
    assert _counters(t.stats) == _counters(j.stats)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bounded_queue_rejects_like_reference(backend):
    j, t = _pair(backend, n_slots=1, chunk_steps=4,
                 admission=BoundedQueuePolicy(max_depth=1),
                 j_admission=jadm.BoundedQueuePolicy(max_depth=1))
    jspecs, tspecs = _specs([8, 8, 8, 8], seed=3)
    jv = _verdicts([j.submit(s, arrival_time=0.0) for s in jspecs])
    tv = _verdicts([t.submit(s, arrival_time=0.0) for s in tspecs])
    assert tv == jv and sum(v is not None for v in tv) == 3
    assert all(v[0] == "queue_full" and v[1] > 0 for v in tv if v)
    assert t.pending == j.pending == 1
    rejected = [r for r in t.results.values() if r.rejected]
    assert all(r.output is None and r.status == "rejected"
               for r in rejected)
    jr, tr = j.run(), t.run()
    assert sorted(tr) == sorted(jr)
    assert _counters(t.stats) == _counters(j.stats) == (1, 3, 0, 0, 1)
    np.testing.assert_allclose(tr[0].preds, np.asarray(jr[0].preds),
                               atol=TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_admitted_requests_bit_identical_to_unpoliced(backend):
    _j, free = _pair(backend, n_slots=1, chunk_steps=4)
    _j, policed = _pair(backend, n_slots=1, chunk_steps=4,
                        admission=BoundedQueuePolicy(max_depth=64))
    _js, tspecs = _specs([8, 8, 8], seed=4)
    for srv in (free, policed):
        for s in tspecs:
            srv.submit(s, arrival_time=0.0)
    want, got = free.run(), policed.run()
    assert len(got) == 3
    for uid in want:
        np.testing.assert_array_equal(got[uid].output, want[uid].output)


@pytest.mark.parametrize("backend", BACKENDS)
def test_deadline_shed_at_the_door_like_reference(backend):
    j, t = _pair(backend, n_slots=1, chunk_steps=4,
                 admission=DeadlineShedPolicy(),
                 j_admission=jadm.DeadlineShedPolicy())
    outs = {}
    for name, srv, spec_cls in (("j", j, jserve.SubmitSpec),
                                ("t", t, SubmitSpec)):
        srv.submit(spec_cls(np.ones((32, 1), np.float32), uid="long"),
                   arrival_time=0.0)
        doomed = srv.submit(spec_cls(np.ones((4, 1), np.float32),
                                     uid="tight", deadline=2.0),
                            arrival_time=0.0)
        ok = srv.submit(spec_cls(np.ones((4, 1), np.float32), uid="lax"),
                        arrival_time=0.0)
        outs[name] = (_verdicts([doomed, ok]), srv.run())
    assert outs["t"][0] == outs["j"][0]
    (reason, retry), queued = outs["t"][0]
    assert reason == "deadline_unmeetable" and retry > 0 and queued is None
    assert _counters(t.stats) == _counters(j.stats)
    assert t.stats.shed == 1 and t.stats.rejected == t.stats.timed_out == 0
    for uid in ("long", "lax"):
        np.testing.assert_allclose(outs["t"][1][uid].preds,
                                   np.asarray(outs["j"][1][uid].preds),
                                   atol=TOL)


# -- tenant fairness ---------------------------------------------------------
_FAIRNESS = [
    ([("a", 1)], [], 4, "a", {}),
    ([("a", 3), ("b", 1)], ["a", "a"], 4, "a", {}),
    ([("a", 3), ("b", 1)], ["a", "a"], 4, "b", {}),
    ([("a", 3), ("b", 2)], [], 4, "a", {}),
    ([("a", 3), ("b", 2)], [], 4, "a", {"a": 3.0, "b": 1.0}),
    ([("a", 2), ("b", 2)], ["b", "c"], 4, "c", {"c": 0.5}),
]


@pytest.mark.parametrize("seated,queued,n_slots,cand,weights", _FAIRNESS)
def test_tenant_fairness_matches_reference(seated, queued, n_slots, cand,
                                           weights):
    srv = _FakeServer([_FakeQ(m) for m, n in seated for _ in range(n)],
                      [_FakeQ(m) for m in queued], n_slots)
    got = TenantFairnessPolicy(weights=weights).admit(srv, _FakeQ(cand))
    want = jadm.TenantFairnessPolicy(weights=weights).admit(srv, _FakeQ(cand))
    assert (got is None) == (want is None)
    if got is not None:
        assert isinstance(got, Rejection)
        assert (got.reason, got.retry_after_s, got.shed) == \
            (want.reason, want.retry_after_s, want.shed)


@pytest.mark.parametrize("backend", BACKENDS)
def test_multi_tenant_fairness_server_like_reference(backend):
    """Two registry tenants behind TenantFairnessPolicy: the same
    submissions are refused, the rest complete."""
    outcomes = {}
    for pkg in ("j", "t"):
        (ra, pa), (rb, pb) = _params(1), _params(2)
        if pkg == "j":
            reg = jserve.ModelRegistry(backend="xla")
            reg.register("a", ra)
            reg.register("b", rb)
            eng = reg.engine("a")
            eng.stats = jserve.ServeStats()
            srv = jserve.AsyncReservoirServer(
                eng, n_slots=2, chunk_steps=4, chunk_time=1.0,
                registry=reg, stats=jserve.ServeStats(),
                admission=jadm.TenantFairnessPolicy())
            spec_cls = jserve.SubmitSpec
        else:
            reg = ModelRegistry(backend=backend)
            reg.register("a", pa)
            reg.register("b", pb)
            eng = reg.engine("a")
            eng.stats = ServeStats()
            srv = AsyncReservoirServer(
                eng, n_slots=2, chunk_steps=4, chunk_time=1.0,
                registry=reg, stats=ServeStats(),
                admission=TenantFairnessPolicy())
            spec_cls = SubmitSpec
        order = [("a", f"a{i}") for i in range(4)] + [("b", "b0"),
                                                      ("a", "a4")]
        verdicts = _verdicts([
            srv.submit(spec_cls(np.ones((8, 1), np.float32), model=m,
                                uid=uid), arrival_time=0.0)
            for m, uid in order])
        res = srv.run()
        outcomes[pkg] = (verdicts, srv.stats.completed, len(res), res)
    assert outcomes["t"][:3] == outcomes["j"][:3]
    assert outcomes["t"][0][-1][0] == "tenant_over_share"
    assert outcomes["t"][1:3] == (5, 6)
    for uid, r in outcomes["t"][3].items():
        if not r.rejected:
            np.testing.assert_allclose(
                r.preds, np.asarray(outcomes["j"][3][uid].preds), atol=TOL)


def test_composite_first_rejection_wins_and_default_shape():
    srv = _FakeServer([], [_FakeQ(None)], n_slots=2)
    got = CompositePolicy(DeadlineShedPolicy(),
                          BoundedQueuePolicy(max_depth=0)).admit(
        srv, _FakeQ(None))
    want = jadm.CompositePolicy(jadm.DeadlineShedPolicy(),
                                jadm.BoundedQueuePolicy(max_depth=0)).admit(
        srv, _FakeQ(None))
    assert (got.reason, got.retry_after_s) == (want.reason,
                                               want.retry_after_s)
    pol = default_policy(max_depth=7, weights={"a": 2.0})
    assert [type(p) for p in pol.policies] == [
        BoundedQueuePolicy, DeadlineShedPolicy, TenantFairnessPolicy]
    assert pol.policies[0].max_depth == 7
    assert pol.policies[2].weights == {"a": 2.0}


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_deadline_ignored_warns_once(backend):
    import repro_torch.serve.engine as engine_mod
    _ref, port = _params()
    eng = ReservoirEngine(port, backend=backend)
    u = np.ones((8, 1), np.float32)
    engine_mod._WARNED_DEADLINE = False
    with pytest.warns(UserWarning, match="deadline"):
        res = eng.submit(SubmitSpec(u, deadline=5.0))
    assert res.timings["deadline_ignored"] is True
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert eng.submit(SubmitSpec(u, deadline=5.0)).timings[
            "deadline_ignored"] is True
    assert "deadline_ignored" not in eng.submit(SubmitSpec(u)).timings


@pytest.mark.parametrize("backend", BACKENDS)
def test_expired_request_dropped_while_pool_full_like_reference(backend):
    j, t = _pair(backend, n_slots=1, chunk_steps=2)
    trail = {}
    for name, srv, spec_cls in (("j", j, jserve.SubmitSpec),
                                ("t", t, SubmitSpec)):
        srv.submit(spec_cls(np.ones((8, 1), np.float32), uid="A"),
                   arrival_time=0.0)
        srv.submit(spec_cls(np.ones((2, 1), np.float32), uid="B",
                            deadline=2.0), arrival_time=0.0)
        marks = []
        for _ in range(3):
            srv.step()
            marks.append((srv.now, srv.stats.timed_out, srv.pending,
                          srv.batcher.live))
        res = srv.run()
        trail[name] = (marks, sorted(res), srv.stats.completed)
    assert trail["t"] == trail["j"]
    assert trail["t"][0][-1] == (3.0, 1, 0, 1)       # dropped, pool full
    assert trail["t"][1:] == (["A"], 1)
