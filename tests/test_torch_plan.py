"""The port lowers a matrix exactly as the JAX package does.

For a given byte budget and crossover the port's ``col_terms``,
``band_plans()``, banded tile data, ``RolloutProgram.schedules`` and tiles,
summaries and stats must ``==`` the reference's — both regimes, both
modes — and the schedule-driven integer product must be exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse import FixedMatrix as JFixedMatrix
from repro.core.sparse import random_sparse_matrix as j_random_sparse
from repro.plan import plan_for as j_plan_for
from repro.plan import specialize_rollout as j_specialize
from repro.plan import specialize_summary as j_summary
from repro.plan.specialize import int8_recur_reference as j_recur
from repro_torch.core.sparse import FixedMatrix, random_sparse_matrix
from repro_torch.plan import (DEFAULT_VMEM_BUDGET, plan_cache_stats,
                              plan_for, specialize_rollout,
                              specialize_summary)
from repro_torch.plan.specialize import int8_recur_reference


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


TILE = 64 * 64
# (matrix kind, mode, budget): None = resident; the small budgets force
# the pipelined regime (each column's tiles still fit half the budget)
CASES = [
    ("dense-blocks", "fp32", None), ("dense-blocks", "fp32", TILE * 4 * 10),
    ("dense-blocks", "int8", None), ("dense-blocks", "int8", TILE * 10),
    ("sparse", "int8", None), ("sparse", "int8", 32 * 32 * 16),
]

_PLANS = {}


def _plans(kind):
    if kind not in _PLANS:
        es, block = (0.9, 64) if kind == "dense-blocks" else (0.97, 32)
        rng = np.random.default_rng(0)
        ref = JFixedMatrix.compile(j_random_sparse(256, 256, es, rng) * 0.05,
                                   weight_bits=8, mode="csd", block=block,
                                   rng=rng)
        rng = np.random.default_rng(0)
        port = FixedMatrix.compile(random_sparse_matrix(256, 256, es, rng)
                                   * 0.05, weight_bits=8, mode="csd",
                                   block=block, rng=rng)
        _PLANS[kind] = (j_plan_for(ref), plan_for(port))
    return _PLANS[kind]


@pytest.mark.parametrize("kind", ["dense-blocks", "sparse"])
@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_col_terms_identical(kind, mode):
    ref, port = _plans(kind)
    assert port.col_terms(mode) == ref.col_terms(mode)


@pytest.mark.parametrize("kind", ["dense-blocks", "sparse"])
def test_plan_stats_and_masks_identical(kind):
    ref, port = _plans(kind)
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.plane_mask == ref.plane_mask
    np.testing.assert_array_equal(port.plane_block_mask, ref.plane_block_mask)
    np.testing.assert_array_equal(port.int8_tiles, ref.int8_tiles)
    np.testing.assert_array_equal(port.fp32_tiles, ref.fp32_tiles)


@pytest.mark.parametrize("kind,mode,budget", [
    ("dense-blocks", "fp32", DEFAULT_VMEM_BUDGET),
    ("dense-blocks", "fp32", TILE * 4 * 4),
    ("dense-blocks", "int8", TILE * 64), ("sparse", "int8", 32 * 32 * 192)])
def test_banded_layout_identical(kind, mode, budget):
    ref, port = _plans(kind)
    assert port.band_partition(mode, budget) == ref.band_partition(mode,
                                                                   budget)
    a, b = ref.rollout_layout(mode, budget), port.rollout_layout(mode, budget)
    assert b.band_plans() == a.band_plans()
    assert b.max_terms == a.max_terms and b.n_bands == a.n_bands
    np.testing.assert_array_equal(b.data, np.asarray(a.data))


@pytest.mark.parametrize("kind,mode,budget", CASES)
def test_rollout_program_identical(kind, mode, budget):
    ref, port = _plans(kind)
    a = j_specialize(ref, mode, vmem_budget=budget, batch_tile_max=8)
    b = specialize_rollout(port, mode, vmem_budget=budget, batch_tile_max=8)
    assert b.regime == a.regime == ("resident" if budget is None
                                    else "pipelined")
    assert b.schedules == a.schedules
    np.testing.assert_array_equal(b.data, np.asarray(a.data))
    for f in ("max_terms", "n_matmul_terms", "n_shiftadd_terms",
              "shiftadd_digits", "resident_bytes", "crossover"):
        assert getattr(b, f) == getattr(a, f), f
    assert b.batch_tiling(13) == a.batch_tiling(13)


@pytest.mark.parametrize("crossover", [0, 8, 10**9])
def test_crossover_schedules_identical(crossover):
    ref, port = _plans("sparse")
    a = j_specialize(ref, "int8", vmem_budget=None, crossover=crossover)
    b = specialize_rollout(port, "int8", vmem_budget=None,
                           crossover=crossover)
    assert b.schedules == a.schedules
    np.testing.assert_array_equal(b.data, np.asarray(a.data))
    assert (specialize_summary(port, "int8", vmem_budget=None,
                               crossover=crossover)
            == j_summary(ref, "int8", vmem_budget=None, crossover=crossover))


@pytest.mark.parametrize("kind", ["dense-blocks", "sparse"])
def test_int8_recur_reference_exact(kind):
    """The port's schedule walk == the reference's == the dense product."""
    ref, port = _plans(kind)
    xq = np.random.default_rng(1).integers(-128, 128, (4, 256))
    a = j_specialize(ref, "int8", vmem_budget=None)
    b = specialize_rollout(port, "int8", vmem_budget=None)
    want = np.asarray(j_recur(a, jnp.asarray(xq, jnp.int32), ref.rows_pad,
                              256))
    got = int8_recur_reference(b, torch.as_tensor(xq, dtype=torch.int32),
                               port.rows_pad, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), xq @ port._fm.q.astype(np.int64))


def test_describe_and_cache():
    _ref, port = _plans("dense-blocks")
    text = port.describe()
    assert "specialized: fp32" in text and "specialized: int8" in text
    before = plan_cache_stats()
    assert plan_for(port._fm) is port
    assert plan_cache_stats()["hits"] == before["hits"] + 1
    # the lowering's budget keeps the reference's value
    assert DEFAULT_VMEM_BUDGET == 8 * 2**20
