"""Engine and continuous-batching server: port vs the JAX package.

Both packages serve the same weights (carried with ``params_from_numpy``)
and the same arrival trace.  Admission order and deadline drops must be
identical; outputs match the reference within 1e-5 (float32 math in two
frameworks); inside the port, chunked serving equals one-shot serving bit
for bit.  The reference runs its XLA backend (its fastest CPU path).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import esn as jesn
from repro.serve import AsyncReservoirServer as JServer
from repro.serve import ReservoirEngine as JEngine
from repro.serve import SubmitSpec as JSpec
from repro_torch.core import esn as tesn
from repro_torch.runtime.faults import FaultEvent, FaultPlan
from repro_torch.serve import (AsyncReservoirServer, ContinuousBatcher,
                               ReservoirEngine, ServeStats, SubmitSpec,
                               engine_cache_clear, engine_cache_stats,
                               engine_for)
from repro_torch.serve.engine import ENGINE_CACHE_MAX

TOL = 1e-5
MODES = ("int8-csd", "fp32")
_PARAMS = {}


def _params(mode):
    """(reference params, port params) with a trained 2-output readout."""
    if mode not in _PARAMS:
        cfg = dict(reservoir_dim=128, element_sparsity=0.8, mode=mode,
                   leak=0.7, seed=1, block=32, output_dim=2)
        ref = jesn.init_esn(jesn.ESNConfig(**cfg))
        rng = np.random.default_rng(1)
        u = rng.standard_normal((60, 1)).astype(np.float32)
        y = np.concatenate([u, np.roll(u, 1, axis=0)], axis=-1)
        states = jesn.run_reservoir(ref, jnp.asarray(u), engine="scan")
        ref = jesn.fit_readout(ref, states, jnp.asarray(y), lam=1e-2)
        port = tesn.params_from_numpy(
            q=np.asarray(ref.w.q), scale=ref.w.scale, pos=ref.w.planes.pos,
            neg=ref.w.planes.neg, block_mask=ref.w.blocks.mask,
            w_in=np.asarray(ref.w_in), w_out=np.asarray(ref.w_out),
            config=tesn.ESNConfig(**cfg), device="cpu")
        _PARAMS[mode] = (ref, port)
    return _PARAMS[mode]


def _trace(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, 1)).astype(np.float32) for t in lengths]


@pytest.mark.parametrize("mode", MODES)
def test_run_reservoir_and_readout_match_reference(mode):
    ref, port = _params(mode)
    u = np.random.default_rng(2).standard_normal((3, 20, 1)).astype(
        np.float32)
    want_s = np.asarray(jesn.run_reservoir(ref, jnp.asarray(u)))
    want_p = np.asarray(jesn.run_readout(ref, jnp.asarray(u)))
    got_s = tesn.run_reservoir(port, torch.as_tensor(u))
    got_p = tesn.run_readout(port, torch.as_tensor(u))
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=TOL)
    np.testing.assert_allclose(got_p.numpy(), want_p, atol=TOL)
    # and against the port's own plain per-step loop
    np.testing.assert_allclose(
        tesn.run_reservoir(port, torch.as_tensor(u), engine="scan").numpy(),
        got_s.numpy(), atol=TOL)


@pytest.mark.parametrize("mode", MODES)
def test_submit_many_matches_reference(mode):
    ref, port = _params(mode)
    seqs = _trace([5, 17, 9, 33])
    want = JEngine(ref, backend="xla").submit_many(
        [JSpec(s, uid=i) for i, s in enumerate(seqs)])
    got = ReservoirEngine(port).submit_many(
        [SubmitSpec(s, uid=i) for i, s in enumerate(seqs)])
    for i in range(len(seqs)):
        np.testing.assert_allclose(got[i].preds.numpy(),
                                   np.asarray(want[i].preds), atol=TOL)
    one = ReservoirEngine(port).submit(SubmitSpec(seqs[1], want_states=True))
    assert torch.equal(one.final_state, one.states[-1])


def _serve(server_cls, spec_cls, eng, seqs, arrivals, deadlines=None,
           **kw):
    srv = server_cls(eng, chunk_time=1.0, **kw)
    qs = []
    for i, (s, at) in enumerate(zip(seqs, arrivals)):
        dl = None if deadlines is None else deadlines[i]
        qs.append(srv.submit(spec_cls(s, uid=i), arrival_time=at,
                             deadline=dl))
    return srv, qs, srv.run()


@pytest.mark.parametrize("zero_copy", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_server_matches_reference_trace(mode, zero_copy):
    """Same arrival trace (with one request whose deadline passes while it
    queues behind a full pool): identical admission order and drops,
    outputs within 1e-5 of the reference, and bit-identical to the port's
    one-shot engine."""
    ref, port = _params(mode)
    lengths = [12, 30, 7, 19, 25, 8, 14]
    seqs = _trace(lengths, seed=3)
    arrivals = [0.0, 0.0, 0.5, 1.0, 1.0, 2.5, 6.0]
    deadlines = [None, None, None, None, None, 2.9, None]
    kw = dict(n_slots=3, chunk_steps=8)
    j_srv, j_qs, j_res = _serve(JServer, JSpec, JEngine(ref, backend="xla"),
                                seqs, arrivals, deadlines, **kw)
    eng = ReservoirEngine(port, stats=ServeStats())
    srv, qs, res = _serve(AsyncReservoirServer, SubmitSpec, eng, seqs,
                          arrivals, deadlines, zero_copy=zero_copy, **kw)
    j_order = [q.uid for q in sorted(
        (q for q in j_qs if q.admit_time is not None),
        key=lambda q: (q.admit_time, q.seq))]
    assert srv.admission_order == j_order
    assert [q.admit_time for q in qs] == [q.admit_time for q in j_qs]
    assert sorted(res) == sorted(j_res)
    assert srv.stats.timed_out == j_srv.stats.timed_out == 1
    one = eng.submit_many([SubmitSpec(seqs[i], uid=i) for i in res])
    for uid, r in res.items():
        np.testing.assert_allclose(r.preds, np.asarray(j_res[uid].preds),
                                   atol=TOL)
        np.testing.assert_array_equal(r.preds, one[uid].preds.numpy())
        assert r.timings["finish_time"] == j_res[uid].timings["finish_time"]


def test_mixed_contracts_merge_rows_exactly():
    """States and predictions requested side by side: two full-pool calls
    per chunk, post-chunk states merged with torch.where — both contracts
    stay bit-identical to one-shot."""
    _ref, port = _params("int8-csd")
    eng = ReservoirEngine(port)
    seqs = _trace([20, 11, 27, 9], seed=4)
    srv = AsyncReservoirServer(eng, n_slots=4, chunk_steps=8, chunk_time=1.0)
    for i, s in enumerate(seqs):
        srv.submit(SubmitSpec(s, uid=i, want_states=bool(i % 2)))
    res = srv.run()
    one = eng.submit_many([SubmitSpec(s, uid=i, want_states=bool(i % 2))
                           for i, s in enumerate(seqs)])
    for i in range(len(seqs)):
        assert res[i].output.shape[-1] == (128 if i % 2 else 2)
        np.testing.assert_array_equal(res[i].output, one[i].output.numpy())


def test_transient_fault_retry_is_bit_identical():
    """Injected transient engine-call failures are retried from the carried
    state: the replay is bit-identical and the retries are accounted."""
    _ref, port = _params("int8-csd")
    eng = ReservoirEngine(port)
    seqs = _trace([16, 10], seed=5)
    clean = AsyncReservoirServer(eng, n_slots=2, chunk_steps=8,
                                 chunk_time=1.0)
    for i, s in enumerate(seqs):
        clean.submit(SubmitSpec(s, uid=i))
    want = clean.run()
    srv = AsyncReservoirServer(eng, n_slots=2, chunk_steps=8, chunk_time=1.0,
                               stats=ServeStats())
    plan = FaultPlan([FaultEvent("transient", at=0.0, count=2)])
    plan.begin_chunk(0.0)
    srv.batcher.fault_plan = plan
    for i, s in enumerate(seqs):
        srv.submit(SubmitSpec(s, uid=i))
    got = srv.run()
    assert srv.stats.retries == 2 and plan.injected == {"transient": 1}
    assert srv.now > clean.now           # backoff charged to the clock
    for i in range(len(seqs)):
        np.testing.assert_array_equal(got[i].preds, want[i].preds)


def test_unported_server_options_raise():
    _ref, port = _params("fp32")
    eng = ReservoirEngine(port)
    for kw in ({"registry": object()}, {"admission": object()},
               {"fault_plan": FaultPlan()}):
        with pytest.raises(NotImplementedError, match="not ported"):
            AsyncReservoirServer(eng, **kw)
    with pytest.raises(ValueError, match="model"):
        eng.submit(SubmitSpec(np.zeros((3, 1), np.float32), model="m"))


def test_batcher_direct_chunks_and_slot_reuse():
    _ref, port = _params("fp32")
    eng = ReservoirEngine(port)
    b = ContinuousBatcher(eng, n_slots=2, chunk_steps=4)
    from repro_torch.serve.scheduler import QueuedRequest
    from repro_torch.serve.batching import RolloutRequest
    seqs = _trace([6, 3, 5], seed=6)
    b.admit(QueuedRequest(RolloutRequest(0, seqs[0])))
    b.admit(QueuedRequest(RolloutRequest(1, seqs[1])))
    assert not b.has_free_slot()
    retired, real = b.run_chunk()
    assert [q.uid for q, _ in retired] == [1] and real == 7
    assert b.admit(QueuedRequest(RolloutRequest(2, seqs[2]))) == 1
    outs = {}
    while b.live:
        for q, out in b.run_chunk()[0]:
            outs[q.uid] = out
    # one-shot at batch >= 2: a 1-row CPU matmul may take a gemv path
    # that rounds differently (the C-ref-1 caveat, shared by the twins)
    one = eng.submit_many([SubmitSpec(seqs[uid], uid=uid) for uid in (0, 2)])
    for uid in (0, 2):
        np.testing.assert_array_equal(outs[uid], one[uid].preds.numpy())


def test_engine_cache_is_bounded_and_invalidated():
    engine_cache_clear()
    engine_cache_stats(reset=True)
    _ref, port = _params("fp32")
    e1 = engine_for(port)
    assert engine_for(port) is e1 and engine_cache_stats()["hits"] == 1
    swapped = dataclasses.replace(port, w_out=port.w_out * 2)
    assert engine_for(swapped) is not e1
    keep = [dataclasses.replace(port) for _ in range(ENGINE_CACHE_MAX + 2)]
    for p in keep:
        engine_for(p)
    s = engine_cache_stats()
    assert s["size"] <= ENGINE_CACHE_MAX and s["evictions"] >= 2
    engine_cache_clear()
