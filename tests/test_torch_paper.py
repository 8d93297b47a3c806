"""The paper-figure layer and the fixed-matrix path as a whole, against the
JAX package.

* ``core/spatial.py`` (the bit-serial register emulator) and
  ``core/baselines.py`` (the V100 / SIGMA models) are numpy copies: their
  results equal the reference's exactly, over cases of
  tests/test_spatial.py and the dims / sparsities / batches of the paper
  figures in benchmarks/run.py.
* Cross-family, on the unit-scale matrix of tests/test_plan.py (scale 1.0,
  so float and integer paths meet on exact integers): the port's B3 equals
  ``xq @ q`` exactly, B4 with float32 input equals it exactly, and one
  int8 B1 step equals ``tanh(y * recur_scale)`` exactly; B3 and B4 equal
  the reference's outputs bit for bit, B1 equals the reference's one-step
  state within 2 ulp of 1.0 (torch's and XLA's CPU tanh round apart by up
  to 2.4e-7 on about 2 % of this test's elements).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as j_baselines
from repro.core import spatial as j_spatial
from repro.core.sparse import FixedMatrix as JFixedMatrix
from repro.kernels.bcsr_matmul.ops import BcsrMatmul as JBcsrMatmul
from repro.kernels.bitplane_gemv.ops import BitplaneGemv as JBitplaneGemv
from repro.kernels.reservoir_rollout.ops import FusedRollout as JFusedRollout
from repro_torch.core import baselines, spatial
from repro_torch.core.sparse import FixedMatrix
from repro_torch.kernels.bcsr_matmul.ops import BcsrMatmul
from repro_torch.kernels.bitplane_gemv.ops import BitplaneGemv
from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
from repro_torch.plan import plan_for


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


CPU = "cpu"


# -- core/spatial.py ----------------------------------------------------------
@pytest.mark.parametrize("mode", ["pn", "csd"])
@pytest.mark.parametrize("r,c,bi,bw", [(8, 4, 8, 8), (13, 5, 8, 8),
                                       (64, 16, 8, 8), (5, 7, 12, 6)])
def test_simulate_gemv_identical(mode, r, c, bi, bw):
    rng = np.random.default_rng(r * 1000 + c)
    v = rng.integers(-(1 << (bw - 1)), 1 << (bw - 1), size=(r, c))
    a = rng.integers(-(1 << (bi - 1)), 1 << (bi - 1), size=(r,))
    seed = r + c
    want = j_spatial.simulate_gemv(v, a, bi, bw, mode=mode,
                                   rng=np.random.default_rng(seed))
    got = spatial.simulate_gemv(v, a, bi, bw, mode=mode,
                                rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(got.output, want.output)
    np.testing.assert_array_equal(got.output, a @ v)
    assert (got.cycles_simulated, got.delay, got.eq5, got.ones) == (
        want.cycles_simulated, want.delay, want.eq5, want.ones)


@pytest.mark.parametrize("dim", [64, 128, 256, 512, 1024, 2048, 4096])
def test_latency_models_identical(dim):
    assert spatial.eq5_latency(8, 8, dim) == j_spatial.eq5_latency(8, 8, dim)
    assert spatial.pipeline_delay(10, 8) == j_spatial.pipeline_delay(10, 8)
    assert spatial.eq5_latency(8, 8, 1024) == 28     # the paper's example


# -- core/baselines.py (benchmarks/run.py figure sweeps) ----------------------
FIG_DIMS = (64, 128, 256, 512, 1024, 2048, 4096)
FIG_SPARSITIES = (0.70, 0.75, 0.80, 0.85, 0.90, 0.95, 0.98)
FIG_BATCHES = (1, 2, 4, 8, 16, 32, 64)


@pytest.mark.parametrize("library", ["cusparse", "sputnik"])
def test_gpu_model_identical(library):
    """Figs 13-18: the dim sweep at 98 %, the sparsity sweep at 1024 and
    the batch sweep at 1024 and 64 (95 %)."""
    cases = ([(d, 0.98, 1) for d in FIG_DIMS]
             + [(1024, es, 1) for es in FIG_SPARSITIES]
             + [(d, 0.95, b) for d in (1024, 64) for b in FIG_BATCHES])
    for dim, es, batch in cases:
        assert baselines.gpu_latency_s(dim, es, library, batch) == \
            j_baselines.gpu_latency_s(dim, es, library, batch)


def test_sigma_model_identical():
    """Figs 19-23: the dim and sparsity sweeps and the batch sweep."""
    cases = ([(d, 0.98, 1) for d in FIG_DIMS]
             + [(1024, es, 1) for es in FIG_SPARSITIES]
             + [(1024, 0.95, b) for b in FIG_BATCHES])
    for dim, es, batch in cases:
        assert baselines.sigma_latency_s(dim, es, batch) == \
            j_baselines.sigma_latency_s(dim, es, batch)
    for name in ("V100Model", "SigmaModel"):
        assert dataclasses.asdict(getattr(baselines, name)()) == \
            dataclasses.asdict(getattr(j_baselines, name)())


# -- the fixed-matrix path, every family from one plan ------------------------
def _unit_scale_q(dim=256, seed=0):
    """tests/test_plan.py's integer matrix: amax == qmax so scale == 1.0,
    row blocks past the first half zero (culled)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(dim, dim)).astype(np.float64)
    q[rng.random((dim, dim)) < 0.9] = 0
    q[dim // 2:, :] = 0
    q[0, 0] = 127
    return q, rng


def _unit_scale_pair(dim=256, block=64, seed=0):
    q, rng = _unit_scale_q(dim, seed)
    state = rng.bit_generator.state
    jfm = JFixedMatrix.compile(q, weight_bits=8, mode="csd", block=block,
                               rng=rng)
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    fm = FixedMatrix.compile(q, weight_bits=8, mode="csd", block=block,
                             rng=rng)
    assert fm.scale == jfm.scale == 1.0
    np.testing.assert_array_equal(fm.planes.pos, np.asarray(jfm.planes.pos))
    return jfm, fm


@pytest.mark.parametrize("x_dtype", [np.int8, np.int32])
def test_bit_identical_across_families(x_dtype):
    jfm, fm = _unit_scale_pair()
    plan = plan_for(fm)
    xq = np.random.default_rng(1).integers(-4, 5, size=(3, 256))
    exact = xq @ fm.q.astype(np.int64)

    # family 1: digit-plane gemv, exact integer
    y_int = BitplaneGemv(plan, device=CPU)(torch.as_tensor(xq.astype(x_dtype)))
    np.testing.assert_array_equal(y_int.numpy(), exact)
    np.testing.assert_array_equal(
        y_int.numpy(), np.asarray(JBitplaneGemv(jfm)(jnp.asarray(
            xq.astype(x_dtype)))))

    # family 2: BCSR float matmul — scale 1.0 keeps it exact integers
    xf = xq.astype(np.float32)
    y_bcsr = BcsrMatmul(plan, device=CPU)(torch.as_tensor(xf))
    np.testing.assert_array_equal(y_bcsr.numpy(), exact.astype(np.float32))
    np.testing.assert_array_equal(
        y_bcsr.numpy(), np.asarray(JBcsrMatmul(jfm)(jnp.asarray(xf))))
    # ... and on integer input, int32 out
    y_bi = BcsrMatmul(plan, device=CPU)(torch.as_tensor(xq.astype(x_dtype)))
    np.testing.assert_array_equal(y_bi.numpy(), exact)

    # family 3: fused rollout, int8 mode, one step with w_in = 0 and x0
    # chosen so the per-step requantization recovers xq exactly
    w_in = np.zeros((1, 256), np.float32)
    fr = FusedRollout(plan, w_in, leak=1.0, mode="int8", device=CPU)
    x0 = torch.as_tensor(xf) / fr.smax
    got = fr(torch.zeros((1, 3, 1)), x0)[0]
    want = torch.tanh(y_int.to(torch.float32)
                      * torch.tensor(fr.recur_scale, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jfr = JFusedRollout(jfm, w_in, leak=1.0, mode="int8")
    assert jfr.recur_scale == fr.recur_scale
    j_got = np.asarray(jfr(jnp.zeros((1, 3, 1), jnp.float32),
                           jnp.asarray(xf) / jfr.smax))[0]
    np.testing.assert_allclose(got.numpy(), j_got, rtol=0, atol=2 ** -22)


def test_consumers_share_the_same_plan_object():
    q, rng = _unit_scale_q(dim=128, seed=2)
    fm = FixedMatrix.compile(q, weight_bits=8, mode="csd", block=64, rng=rng)
    plan = plan_for(fm)
    assert BitplaneGemv(fm, device=CPU).plan is plan
    assert BcsrMatmul(fm, device=CPU).layout is plan.bcsr
    assert BcsrMatmul(plan, device=CPU).layout is plan.bcsr
    assert FusedRollout(fm, np.zeros((1, 128), np.float32),
                        device=CPU).plan is plan
