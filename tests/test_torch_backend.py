"""The port's ``"torch"`` serve backend against the JAX package's ``"xla"``.

Both engines serve the same weights (carried with ``params_from_numpy``)
on the same seeded numpy inputs, in every schedule the backend has
(``fp32-dense``, ``fp32-culled``, ``int8-folded-dense``,
``int8-folded-culled``, ``int8-planes``):

* the int32 recurrent products equal the reference's exactly;
* states, final states and predictions agree within ``TOL`` (float32 math
  in two frameworks: ``tanh`` and product sums round differently);
* inside the port, the torch backend equals the cuda backend's twin bit
  for bit where the arithmetic is the same — int8 and fp32-culled with one
  input (the input projection is then one product, not a sum, and both
  walk the same integer products or tile products in the same order) —
  and within ``TOL`` where it is not: fp32-dense (one library product vs
  the twin's per-tile sums) and several inputs (the hoisted projection's
  sum order vs the twin's ascending one);
* chunked == one-shot bit for bit on both of the port's backends.

Bit-identity is claimed only at batch >= 2 (a 1-row CPU matmul may round
differently: C-ref-1, C-port-1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import esn as jesn
from repro.plan import specialize_rollout as j_specialize
from repro.plan.specialize import int8_recur_reference as j_recur
from repro.serve import ReservoirEngine as JEngine
from repro.serve import SubmitSpec as JSpec
from repro_torch.core import esn as tesn
from repro_torch.plan import resolve_backend
from repro_torch.plan.specialize import int8_recur_reference
from repro_torch.serve import (ReservoirEngine, SubmitSpec,
                               engine_cache_clear, engine_for)
from repro_torch.serve.engine import BACKENDS


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
DIM = 128

# schedule -> (ESN mode, engine kwargs that select it)
SCHEDULES = {
    "fp32-dense": ("fp32", {}),
    "fp32-culled": ("fp32", {"dense_dispatch_density": 2.0}),
    "int8-folded-dense": ("int8-csd", {}),
    "int8-folded-culled": ("int8-csd", {"dense_dispatch_density": 2.0}),
    "int8-planes": ("int8-csd", {"specialize": False}),
}
_PARAMS = {}


def _params(mode, input_dim=1, es=0.8):
    """(reference params, port params) with a random 2-output readout."""
    key = (mode, input_dim, es)
    if key not in _PARAMS:
        cfg = dict(reservoir_dim=DIM, element_sparsity=es, mode=mode,
                   leak=0.7, seed=1, block=32, output_dim=2,
                   input_dim=input_dim)
        ref = jesn.init_esn(jesn.ESNConfig(**cfg))
        w_out = np.random.default_rng(0).uniform(
            -0.3, 0.3, (DIM, 2)).astype(np.float32)
        ref = jesn.ESNParams(w=ref.w, w_in=ref.w_in,
                             w_out=jnp.asarray(w_out), config=ref.config)
        port = tesn.params_from_numpy(
            q=np.asarray(ref.w.q), scale=ref.w.scale, pos=ref.w.planes.pos,
            neg=ref.w.planes.neg, block_mask=ref.w.blocks.mask,
            w_in=np.asarray(ref.w_in), w_out=w_out,
            config=tesn.ESNConfig(**cfg), device="cpu")
        _PARAMS[key] = (ref, port)
    return _PARAMS[key]


def _inputs(batch, steps, input_dim=1, seed=2):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((batch, steps, input_dim)).astype(np.float32)
    x0 = (0.3 * rng.standard_normal((batch, DIM))).astype(np.float32)
    return u, x0


def _engines(schedule, input_dim=1):
    mode, kw = SCHEDULES[schedule]
    ref, port = _params(mode, input_dim)
    j = JEngine(ref, backend="xla", **kw)
    t = ReservoirEngine(port, backend="torch", **kw)
    assert j.xla_schedule == t.torch_schedule == schedule
    return j, t, kw


def _max(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("input_dim", [1, 3])
def test_torch_backend_matches_xla(schedule, input_dim):
    j, t, _kw = _engines(schedule, input_dim)
    u, x0 = _inputs(4, 20, input_dim)
    for want_states in (True, False):
        js, jf = j.run_segment(jnp.asarray(u), jnp.asarray(x0),
                               want_states=want_states)
        ts, tf = t.run_segment(torch.as_tensor(u), torch.as_tensor(x0),
                               want_states=want_states)
        assert ts.shape == js.shape
        assert _max(ts, js) <= TOL and _max(tf, jf) <= TOL


def _quantized(seed=5):
    """int32 quantized states, as the int8 loop makes them each step."""
    rng = np.random.default_rng(seed)
    return np.clip(np.round(rng.uniform(-1, 1, (3, DIM)) * 127), -128,
                   127).astype(np.int32)


@pytest.mark.parametrize("schedule", ["int8-folded-dense",
                                      "int8-folded-culled", "int8-planes"])
def test_int8_products_equal_reference_exactly(schedule):
    """The integer product each int8 schedule runs == the reference's
    ``matvec_int_exact`` (and its schedule walk), to the last bit."""
    j, t, _kw = _engines(schedule)
    xq = _quantized()
    want = np.asarray(j.params.w.matvec_int_exact(jnp.asarray(xq)))
    got = t._int_product(torch.as_tensor(xq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if schedule == "int8-folded-culled":
        # the same schedule walk as the reference's, term for term
        jp = j_specialize(j.plan, "int8", vmem_budget=j.vmem_budget,
                          crossover=j.crossover, batch_tile_max=16)
        assert jp.schedules == t._program.schedules
        jr = j_recur(jp, jnp.asarray(xq), j.plan.rows_pad, DIM)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jr))


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("input_dim", [1, 3])
def test_torch_backend_matches_cuda_twin(schedule, input_dim):
    _j, t, kw = _engines(schedule, input_dim)
    c = ReservoirEngine(t.params, backend="cuda", **kw)
    u, x0 = _inputs(4, 20, input_dim, seed=7)
    exact = input_dim == 1 and schedule != "fp32-dense"
    for want_states in (True, False):
        ts, tf = t.run_segment(torch.as_tensor(u), torch.as_tensor(x0),
                               want_states=want_states)
        cs, cf = c.run_segment(torch.as_tensor(u), torch.as_tensor(x0),
                               want_states=want_states)
        if exact:
            assert torch.equal(ts, cs) and torch.equal(tf, cf)
        else:
            assert _max(ts, cs) <= TOL and _max(tf, cf) <= TOL


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_chunked_equals_one_shot(backend, schedule):
    """Three chunks resumed from the carry (the last with the carry
    written in place) == one call, bit for bit, on both backends."""
    mode, kw = SCHEDULES[schedule]
    _ref, port = _params(mode)
    eng = ReservoirEngine(port, backend=backend, **kw)
    u, x0 = _inputs(3, 24, seed=11)
    u, x0 = torch.as_tensor(u), torch.as_tensor(x0)
    one, xf = eng.run_segment(u, x0)
    parts, carry = [], x0.clone()
    for lo, hi in ((0, 8), (8, 16)):
        out, carry = eng.run_segment(u[:, lo:hi], carry)
        parts.append(out)
    buf = carry.clone()
    out, last = eng.run_segment(u[:, 16:], buf, donate_state=True)
    parts.append(out)
    assert last.data_ptr() == buf.data_ptr()
    assert torch.equal(torch.cat(parts, dim=1), one)
    assert torch.equal(last, xf)


def test_run_reservoir_and_readout_accept_both_backends():
    ref, port = _params("int8-csd")
    u, _ = _inputs(3, 16, seed=13)
    want_s = np.asarray(jesn.run_reservoir(ref, jnp.asarray(u),
                                           engine="xla"))
    want_p = np.asarray(jesn.run_readout(ref, jnp.asarray(u), engine="xla"))
    for engine in ("torch", "cuda", "auto"):
        got_s = tesn.run_reservoir(port, torch.as_tensor(u), engine=engine)
        got_p = tesn.run_readout(port, torch.as_tensor(u), engine=engine)
        assert _max(got_s, want_s) <= TOL and _max(got_p, want_p) <= TOL
    with pytest.raises(ValueError, match="engine"):
        tesn.run_reservoir(port, torch.as_tensor(u), engine="xla")


def test_backend_names_and_engine_cache():
    engine_cache_clear()
    _ref, port = _params("fp32")
    assert BACKENDS == ("auto", "torch", "cuda")
    t, c = engine_for(port, "torch"), engine_for(port, "cuda")
    assert (t.backend, c.backend) == ("torch", "cuda")
    # "auto" resolves through the autotuner ("torch" on the CPU, the
    # reference's "xla"), and the cache keys the resolved backend
    assert resolve_backend(port) == "torch"
    assert engine_for(port, "torch") is t and engine_for(port) is t
    assert engine_for(port, "cuda") is c
    # only the cuda backend builds the kernel op
    assert not hasattr(t, "_fused") and hasattr(c, "_fused")
    with pytest.raises(ValueError, match="backend"):
        ReservoirEngine(port, backend="xla")
    engine_cache_clear()


def test_trace_counts_one_per_key():
    """N calls of one shape set up once; a new shape is one new key, and
    the donated variant is none (it only picks the final state's buffer)."""
    _ref, port = _params("int8-csd")
    eng = ReservoirEngine(port, backend="torch")
    u, x0 = _inputs(2, 4, seed=17)
    u, x0 = torch.as_tensor(u), torch.as_tensor(x0)
    for _ in range(3):
        eng.run_segment(u, x0)
    assert sum(eng.trace_counts.values()) == 1
    assert all(n == 1 for n in eng.trace_counts.values())
    eng.run_segment(torch.cat([u, u], dim=1), x0)
    eng.run_segment(u, x0.clone(), donate_state=True)
    assert sum(eng.trace_counts.values()) == 2
    assert all(n == 1 for n in eng.trace_counts.values())
    assert set(eng.trace_counts) == {
        ((2, 4, 1), True, True, "int8-folded-dense"),
        ((2, 8, 1), True, True, "int8-folded-dense")}


def test_torch_backend_copies_nothing_from_the_host_per_step(monkeypatch):
    """Every operand of the loop was placed at engine build: a rollout
    converts no numpy array (no host->device copy per step)."""
    for schedule in SCHEDULES:
        _j, t, _kw = _engines(schedule)
        u, x0 = _inputs(2, 6, seed=19)
        u, x0 = torch.as_tensor(u), torch.as_tensor(x0)
        calls = []
        real = torch.as_tensor

        def counting(data, *a, **k):
            if isinstance(data, np.ndarray):
                calls.append(schedule)
            return real(data, *a, **k)

        monkeypatch.setattr(torch, "as_tensor", counting)
        t.run_segment(u, x0)
        monkeypatch.setattr(torch, "as_tensor", real)
        assert calls == [], schedule


def test_helpers_with_placed_operands_are_unchanged():
    """matmul_ref(tiles=), matvec_int_exact(planes=) and
    int8_recur_reference(data=) give the helpers' own results, bit for
    bit."""
    _j, t, _kw = _engines("int8-folded-culled")
    w = t.params.w
    xq = torch.as_tensor(_quantized(23))
    assert torch.equal(w.matvec_int_exact(xq, planes=w.device_planes("cpu")),
                       w.matvec_int_exact(xq))
    assert torch.equal(
        int8_recur_reference(t._program, xq, t.plan.rows_pad, DIM,
                             data=t._program_data),
        int8_recur_reference(t._program, xq, t.plan.rows_pad, DIM))
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (3, DIM)).astype(np.float32))
    tiles = torch.as_tensor(w.blocks.data)
    assert torch.equal(w.blocks.matmul_ref(x, tiles=tiles),
                       w.blocks.matmul_ref(x))


def test_donate_needs_a_device_tensor():
    _ref, port = _params("fp32")
    eng = ReservoirEngine(port, backend="torch")
    u, x0 = _inputs(2, 4)
    with pytest.raises(ValueError, match="donate_state"):
        eng.run_segment(torch.as_tensor(u), x0, donate_state=True)


def test_submit_and_submit_many_on_the_torch_backend():
    """The one-shot surface on the torch backend: final_state is the
    carry, and the padded microbatch answers match the reference."""
    ref, port = _params("int8-csd")
    eng = ReservoirEngine(port, backend="torch")
    rng = np.random.default_rng(29)
    seqs = [rng.standard_normal((n, 1)).astype(np.float32)
            for n in (5, 17, 9)]
    one = eng.submit(SubmitSpec(seqs[1], want_states=True))
    assert torch.equal(one.final_state, one.states[-1])
    got = eng.submit_many([SubmitSpec(s, uid=i) for i, s in enumerate(seqs)])
    want = JEngine(ref, backend="xla").submit_many(
        [JSpec(s, uid=i) for i, s in enumerate(seqs)])
    for i in range(len(seqs)):
        assert _max(got[i].preds, want[i].preds) <= TOL



def test_culled_schedule_with_shift_add_digits():
    """At 90 % element sparsity the program turns thin digit planes into
    shift-add digits: the torch backend walks them like the reference's
    schedule (exact int32 products), and equals the cuda twin bit for bit
    and the reference within TOL; chunked == one-shot."""
    ref, port = _params("int8-csd", es=0.9)
    kw = {"dense_dispatch_density": 2.0}
    j = JEngine(ref, backend="xla", **kw)
    t = ReservoirEngine(port, backend="torch", **kw)
    assert t.torch_schedule == "int8-folded-culled"
    assert t._program.shiftadd_digits > 0
    xq = _quantized(31)
    np.testing.assert_array_equal(
        t._int_product(torch.as_tensor(xq)).numpy(),
        np.asarray(j.params.w.matvec_int_exact(jnp.asarray(xq))))
    u, x0 = _inputs(3, 16, seed=37)
    js, jf = j.run_segment(jnp.asarray(u), jnp.asarray(x0), want_states=True)
    ts, tf = t.run_segment(torch.as_tensor(u), torch.as_tensor(x0),
                           want_states=True)
    cs, cf = ReservoirEngine(port, backend="cuda", **kw).run_segment(
        torch.as_tensor(u), torch.as_tensor(x0), want_states=True)
    assert _max(ts, js) <= TOL and _max(tf, jf) <= TOL
    assert torch.equal(ts, cs) and torch.equal(tf, cf)
    a, carry = t.run_segment(torch.as_tensor(u[:, :8]), torch.as_tensor(x0),
                             want_states=True)
    b, last = t.run_segment(torch.as_tensor(u[:, 8:]), carry,
                            want_states=True)
    assert torch.equal(torch.cat([a, b], dim=1), ts) and torch.equal(last, tf)
