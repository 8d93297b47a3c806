"""The rollout kernels' plain twins against the JAX package's kernels.

The JAX ``FusedRollout`` / ``SpecializedRollout`` run in Pallas interpret
mode, as the reference's own tests run them, on the ``_kernel_pair`` set of
tests/test_specialize.py: {fp32, int8-pn, int8-csd} x {resident,
pipelined}, dim 256, block 64, leak 0.7, with readout.  Batch >= 2
throughout (the reference's batch-1 rows may differ by an ulp, C-ref-1).

* int8: one port step fed the reference's own x(t-1) gives the exact int32
  recurrent product; whole trajectories over T = 8 agree within 1e-5 (a
  1-ulp tanh difference between the frameworks may flip a requantization).
* fp32: trajectories within 1e-5 (matmul accumulation order differs).
* Inside the port: B2's twin equals B1's twin bit for bit, and chunked
  rollouts resuming from the carried state equal one-shot bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse import FixedMatrix as JFixedMatrix
from repro.core.sparse import random_sparse_matrix as j_random_sparse
from repro.kernels.reservoir_rollout.ops import FusedRollout as JFused
from repro.kernels.reservoir_rollout.specialized import \
    SpecializedRollout as JSpecialized
from repro.plan import plan_for as j_plan_for
from repro_torch.core.sparse import FixedMatrix, random_sparse_matrix
from repro_torch.kernels.reservoir_rollout import _cuda
from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
from repro_torch.kernels.reservoir_rollout.ref import (rollout_fp32_ref,
                                                       rollout_int8_ref)
from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
    check_operands, plain_recurrent_product, reservoir_rollout,
    rollout_readout)
from repro_torch.kernels.reservoir_rollout.specialized import (
    SpecializedRollout, specialized_rollout)
from repro_torch.plan import plan_for

DIM, BLOCK = 256, 64
TILE = BLOCK * BLOCK
PIPELINE_BUDGET = {"fp32": TILE * 4 * 10, "int8": TILE * 10}
MODES = ("fp32", "int8-pn", "int8-csd")
REGIMES = ("resident", "pipelined")
TOL = 1e-5

_PAIRS = {}


def _pair(esn_mode, regime):
    """(reference generic, reference specialized, port generic, port
    specialized) rollout ops for one mode/regime, on identical weights."""
    key = (esn_mode, regime)
    if key not in _PAIRS:
        digit = "pn" if esn_mode == "int8-pn" else "csd"
        kmode = "fp32" if esn_mode == "fp32" else "int8"
        budget = None if regime == "resident" else PIPELINE_BUDGET[kmode]
        rng = np.random.default_rng(0)
        jfm = JFixedMatrix.compile(j_random_sparse(DIM, DIM, 0.9, rng) * 0.05,
                                   weight_bits=8, mode=digit, block=BLOCK,
                                   rng=rng)
        rng = np.random.default_rng(0)
        tfm = FixedMatrix.compile(random_sparse_matrix(DIM, DIM, 0.9, rng)
                                  * 0.05, weight_bits=8, mode=digit,
                                  block=BLOCK, rng=rng)
        rng = np.random.default_rng(7)
        w_in = rng.uniform(-0.5, 0.5, (4, DIM)).astype(np.float32)
        w_out = rng.uniform(-0.1, 0.1, (DIM, 4)).astype(np.float32)
        kw = dict(leak=0.7, mode=kmode, w_out=w_out)
        ops = (JFused(j_plan_for(jfm), w_in, **kw),
               JSpecialized(j_plan_for(jfm), w_in, vmem_budget=budget,
                            batch_tile_max=8, **kw),
               FusedRollout(plan_for(tfm), w_in, device="cpu", **kw),
               SpecializedRollout(plan_for(tfm), w_in, vmem_budget=budget,
                                  batch_tile_max=8, device="cpu", **kw))
        assert ops[1].regime == ops[3].regime == regime
        _PAIRS[key] = ops
    return _PAIRS[key]


def _inputs(batch, t=8, seed=0):
    u = np.random.default_rng(seed).standard_normal((t, batch, 4))
    return u.astype(np.float32)


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("mode", MODES)
def test_twins_match_reference(mode, regime):
    """States, final state and readout vs the reference kernels (1e-5);
    B2 twin == B1 twin bit for bit."""
    j_gen, j_spec, t_gen, t_spec = _pair(mode, regime)
    u = _inputs(batch=9)                 # two batch tiles of <= 8 rows
    rs, rp, rf = j_spec(jnp.asarray(u), want_states=True, want_preds=True,
                        want_final=True)
    out = {}
    for name, op in (("generic", t_gen), ("specialized", t_spec)):
        s, p, f = op(torch.as_tensor(u), want_states=True, want_preds=True,
                     want_final=True)
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=TOL)
        np.testing.assert_allclose(p.numpy(), np.asarray(rp), atol=TOL)
        np.testing.assert_allclose(f.numpy(), np.asarray(rf), atol=TOL)
        out[name] = (s, p, f)
    for a, b in zip(out["generic"], out["specialized"]):
        assert torch.equal(a, b)
    # the reference's own generic kernel agrees with its specialized one
    np.testing.assert_array_equal(
        np.asarray(j_gen(jnp.asarray(u), want_states=True)), np.asarray(rs))


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("mode", ("int8-pn", "int8-csd"))
def test_int8_recurrent_product_exact_from_reference_state(mode, regime):
    """Feed the reference's x(t-1) into one port step: the twin's int32
    recurrent product equals the exact dense product, and the stepped
    state is within 1e-6 of the reference's x(t)."""
    _j_gen, j_spec, _t_gen, t_spec = _pair(mode, regime)
    u = _inputs(batch=3, t=6, seed=1)
    ref_states = np.asarray(j_spec(jnp.asarray(u), want_states=True))
    q = t_spec.plan._fm.q.astype(np.int64)
    for t in range(1, u.shape[0]):
        x = torch.tensor(ref_states[t - 1])
        xq = torch.clamp(torch.round(x * 127), -128, 127).to(torch.int32)
        got = plain_recurrent_product(xq, t_spec.tables)[:, :DIM]
        np.testing.assert_array_equal(got.numpy(), xq.numpy() @ q)
        step = t_spec(torch.as_tensor(u[t:t + 1]), x0=x, want_states=True)
        np.testing.assert_allclose(step[0].numpy(), ref_states[t], atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_chunked_equals_one_shot_with_donated_carry(mode):
    """Two chunks resuming from the carry written in place == one shot,
    bit for bit (states, preds, final)."""
    _j_gen, _j_spec, _t_gen, op = _pair(mode, "pipelined")
    u = torch.as_tensor(_inputs(batch=5))
    s, p, f = op(u, want_states=True, want_preds=True, want_final=True)
    carry = torch.zeros((5, DIM))
    s1, p1, f1 = op(u[:3], carry, want_states=True, want_preds=True,
                    want_final=True, donate_state=True)
    assert f1.data_ptr() == carry.data_ptr()
    s2, p2, f2 = op(u[3:], carry, want_states=True, want_preds=True,
                    want_final=True, donate_state=True)
    assert torch.equal(torch.cat([s1, s2]), s)
    assert torch.equal(torch.cat([p1, p2]), p)
    assert torch.equal(f2, f) and torch.equal(carry, f)


def test_readout_every_k_matches_reference():
    rng = np.random.default_rng(9)
    jfm = JFixedMatrix.compile(j_random_sparse(DIM, DIM, 0.9, rng) * 0.05,
                               weight_bits=8, mode="csd", block=BLOCK,
                               rng=rng)
    rng = np.random.default_rng(9)
    tfm = FixedMatrix.compile(random_sparse_matrix(DIM, DIM, 0.9, rng) * 0.05,
                              weight_bits=8, mode="csd", block=BLOCK, rng=rng)
    w_in = rng.uniform(-0.5, 0.5, (4, DIM)).astype(np.float32)
    w_out = rng.uniform(-0.1, 0.1, (DIM, 4)).astype(np.float32)
    kw = dict(leak=0.6, mode="fp32", w_out=w_out, readout_every=4)
    ref = JSpecialized(j_plan_for(jfm), w_in, batch_tile_max=4, **kw)
    port = SpecializedRollout(plan_for(tfm), w_in, batch_tile_max=4,
                              device="cpu", **kw)
    u = rng.standard_normal((8, 6, 4)).astype(np.float32)
    want = np.asarray(ref(jnp.asarray(u), want_states=False, want_preds=True))
    got = port(torch.as_tensor(u), want_states=False, want_preds=True)
    assert got.shape == want.shape == (2, 6, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_twin_matches_dense_oracle(mode):
    """The banded/culled twin against the dense step-by-step oracle."""
    rng = np.random.default_rng(3)
    fm = FixedMatrix.compile(random_sparse_matrix(128, 128, 0.95, rng) * 0.05,
                             weight_bits=8, mode="csd", block=32, rng=rng)
    w_in = rng.uniform(-0.5, 0.5, (2, 128)).astype(np.float32)
    op = SpecializedRollout(fm, w_in, leak=0.8, mode=mode, device="cpu")
    u = torch.as_tensor(rng.standard_normal((6, 3, 2)).astype(np.float32))
    x0 = torch.zeros((3, 128))
    got = op(u, want_states=True)
    if mode == "fp32":
        want = rollout_fp32_ref(u, fm.dense_f32(), op.w_in, x0, leak=0.8)
    else:
        want = rollout_int8_ref(u, torch.as_tensor(fm.q), fm.scale, op.w_in,
                                x0, leak=0.8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert op.program.n_shiftadd_terms > 0 or mode == "fp32"


def test_cpu_runs_twins_without_building_or_counting():
    """On CPU tensors the wrappers run the twins: nothing is compiled and
    no kernel launch is counted."""
    _j, _js, t_gen, t_spec = _pair("int8-csd", "resident")
    before = (reservoir_rollout.launches, specialized_rollout.launches,
              rollout_readout.launches)
    t_gen(torch.as_tensor(_inputs(batch=2, t=2)), want_preds=True)
    t_spec(torch.as_tensor(_inputs(batch=2, t=2)), want_preds=True)
    assert (reservoir_rollout.launches, specialized_rollout.launches,
            rollout_readout.launches) == before
    assert not _cuda.LIBRARY.loaded


def test_wrapper_rejects_foreign_and_mixed_devices():
    _j, _js, _tg, op = _pair("fp32", "resident")
    x0 = torch.zeros((2, DIM))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        specialized_rollout(torch.zeros((2, 2, 4), device="meta"),
                            op.tables, op.w_in, x0)
    with pytest.raises(ValueError, match="different devices"):
        specialized_rollout(torch.zeros((2, 2, 4)), op.tables, op.w_in,
                            x0.to("meta"))


@pytest.mark.parametrize("batch,in_dim,steps", [(1, 1, 1199), (3, 4, 7),
                                                (16, 1, 1)])
def test_launch_checks_accept_engine_views(batch, in_dim, steps):
    """The engine hands the kernel transposed (T, B, I) views of its
    (B, T, I) inputs; size-1 dims may carry any stride."""
    _j, _js, _tg, op = _pair("int8-csd", "resident")
    u = torch.zeros((1, steps, in_dim))[0][None].expand(
        batch, steps, in_dim).contiguous().transpose(0, 1)
    w_in = torch.zeros((in_dim, DIM))
    x0 = torch.zeros((batch, DIM))
    check_operands(u, op.tables, w_in, x0, op.w_out, x0, 16, True, 1)
    with pytest.raises(ValueError, match="unit stride"):
        check_operands(torch.zeros((steps, batch, 2 * in_dim + 2))[..., ::2],
                       op.tables, torch.zeros((in_dim + 1, DIM)), x0,
                       None, None, 16, False, 1)
    with pytest.raises(ValueError, match="thread block"):
        check_operands(u, op.tables, w_in, x0, None, None, 128, False, 1)
