"""The port's rollout cost model and roofline against the JAX package's.

The same matrices (the port's carried bit for bit from the reference's
compile) give the same ``specialize_summary`` counts, and from them:

* ``rollout_cost_features`` equals the reference's exactly, over several
  summaries, modes, batches and step counts;
* the CPU prior equals the reference's under the backend renaming
  (``xla`` -> ``torch``, ``pallas`` -> ``cuda``);
* ``fit_rollout_cost`` equals the reference's on the same samples to
  relative ``FIT_RTOL``.

The H100 prior and ``rollout_roofline`` have no reference counterpart
(the reference's are TPU numbers): they are held to their own stated
arithmetic and to the ordering the autotuner needs of a prior.
"""

import numpy as np
import pytest
import torch

import jax

from repro.core import costmodel as jcm
from repro.core.sparse import FixedMatrix as JFixed
from repro.core.sparse import random_sparse_matrix
from repro.plan import plan_for as j_plan_for
from repro.plan import specialize_summary as j_summary
from repro_torch.core import costmodel as tcm
from repro_torch.core.bitplanes import DigitPlanes
from repro_torch.core.sparse import FixedMatrix as TFixed
from repro_torch.launch import roofline
from repro_torch.plan import plan_for, specialize_summary


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


FIT_RTOL = 1e-9
RENAME = {"xla": "torch", "pallas": "cuda"}
# budgets that keep (None), band (24 KiB) and pipeline (10 tiles of 64^2
# int8) the dim-256 block-64 matrices below
BUDGETS = [None, 24 * 1024, 10 * 64 * 64]


def _pair(digit="csd", es=0.9, dim=256, block=64, seed=0):
    """(reference plan, port plan) over one compiled matrix."""
    rng = np.random.default_rng(seed)
    w = random_sparse_matrix(dim, dim, es, rng) * 0.05
    w[:, block:2 * block] = 0.0                  # a culled column block
    ref = JFixed.compile(w, weight_bits=8, mode=digit, block=block, rng=rng)
    planes = DigitPlanes(pos=ref.planes.pos, neg=ref.planes.neg,
                         mode=digit, source_bits=8)
    port = TFixed.from_parts(np.asarray(ref.q), ref.scale, planes, block)
    return j_plan_for(ref), plan_for(port)


_PLANS = {}


def _plans(key):
    if key not in _PLANS:
        digit, es, block = key
        _PLANS[key] = _pair(digit, es, block=block)
    return _PLANS[key]


MATRICES = [("csd", 0.9, 64), ("pn", 0.97, 32), ("csd", 0.5, 64)]


@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("mode", ["fp32", "int8"])
@pytest.mark.parametrize("budget", BUDGETS)
def test_features_equal_reference(matrix, mode, budget):
    jp, tp = _plans(matrix)
    for crossover in (0, tp.block, 4 * tp.block):
        for tile in (8, 16, 32):
            kw = dict(vmem_budget=budget, crossover=crossover,
                      batch_tile_max=tile)
            try:
                want_s = j_summary(jp, mode, **kw)
            except ValueError:
                with pytest.raises(ValueError):
                    specialize_summary(tp, mode, **kw)
                continue
            got_s = specialize_summary(tp, mode, **kw)
            assert got_s == want_s
            for batch in (1, 3, 8, 16, 33):
                for steps in (1, 8, 32):
                    got = tcm.rollout_cost_features(got_s, tp.block, batch,
                                                    steps)
                    want = jcm.rollout_cost_features(want_s, jp.block,
                                                     batch, steps)
                    assert got == want
                    assert list(got) == list(tcm.ROLLOUT_FEATURES)


def test_cpu_prior_equals_reference_renamed():
    got = tcm.default_rollout_cost_model("cpu")
    want = jcm.default_rollout_cost_model("cpu")
    assert got.platform == want.platform == "cpu"
    assert set(got.coeffs) == {RENAME[b] for b in want.coeffs}
    for bk, c in want.coeffs.items():
        np.testing.assert_array_equal(got.coeffs[RENAME[bk]], c)
    assert tcm.ROLLOUT_FEATURES == jcm.ROLLOUT_FEATURES


def test_cuda_prior_is_its_own():
    """The card's prior shares no coefficient vector with the
    reference's TPU prior, and unknown platforms are refused."""
    cuda = tcm.default_rollout_cost_model("cuda")
    tpu = jcm.default_rollout_cost_model("tpu")
    assert cuda.platform == "cuda" and set(cuda.coeffs) == {"torch", "cuda"}
    for c in cuda.coeffs.values():
        assert c.shape == (len(tcm.ROLLOUT_FEATURES) + 1,)
        assert (c >= 0).all()
        for t in tpu.coeffs.values():
            assert not np.array_equal(c, t)
    with pytest.raises(ValueError, match="platform"):
        tcm.default_rollout_cost_model("tpu")


@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("mode", ["fp32", "int8"])
@pytest.mark.parametrize("batch,steps", [(8, 8), (16, 32)])
def test_cuda_prior_prices_the_torch_loop_above_one_launch(matrix, mode,
                                                           batch, steps):
    """What the card's prior must get right: one B2 launch per call costs
    less than the host-bound per-step loop, at the default schedule, and
    the CPU prior says the opposite (the cuda backend runs the twins)."""
    _jp, tp = _plans(matrix)
    s = specialize_summary(tp, mode)
    f = tcm.rollout_cost_features(s, tp.block, batch, steps)
    card = tcm.default_rollout_cost_model("cuda")
    cpu = tcm.default_rollout_cost_model("cpu")
    assert card.predict("cuda", f) < card.predict("torch", f)
    assert cpu.predict("torch", f) < cpu.predict("cuda", f)


def _samples(seed, backends=("xla", "pallas"), n=40):
    rng = np.random.default_rng(seed)
    true = {"xla": np.array([3e-11, 1e-9, 5e-11, 1e-6, 5e-7, 2e-6, 2e-4]),
            "pallas": np.array([1e-12, 2e-10, 1e-12, 0.0, 3e-7, 4e-6, 1e-4])}
    out = []
    for i in range(n):
        f = {"matmul_macs": float(rng.integers(1, 100)) * 1e6,
             "shiftadd_ops": float(rng.integers(0, 100)) * 1e3,
             "stream_bytes": float(rng.integers(1, 100)) * 1e5,
             "band_steps": float(rng.integers(1, 64)),
             "tile_steps": float(rng.integers(1, 256)),
             "steps": float(rng.integers(1, 32))}
        bk = backends[i % len(backends)]
        y = float(np.array([f[k] for k in jcm.ROLLOUT_FEATURES] + [1.0])
                  @ true[bk]) * float(rng.uniform(0.9, 1.1))
        out.append((bk, f, y))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backends", [("xla", "pallas"), ("xla",)])
def test_fit_equals_reference(seed, backends):
    samples = _samples(seed, backends)
    want = jcm.fit_rollout_cost(samples, platform="cpu")
    got = tcm.fit_rollout_cost([(RENAME[b], f, y) for b, f, y in samples],
                               platform="cpu")
    assert set(got.coeffs) == {"torch", "cuda"}
    for bk, c in want.coeffs.items():
        np.testing.assert_allclose(got.coeffs[RENAME[bk]], c,
                                   rtol=FIT_RTOL, atol=0.0)
    # a backend without samples keeps its prior
    if "pallas" not in backends:
        np.testing.assert_array_equal(
            got.coeffs["cuda"],
            tcm.default_rollout_cost_model("cpu").coeffs["cuda"])


def test_fit_recovers_synthetic_coefficients_and_round_trips():
    rng = np.random.default_rng(0)
    true = np.array([3e-13, 1e-11, 5e-13, 0.0, 5e-7, 3e-6, 1.5e-4])
    samples = []
    for _ in range(48):
        f = {"matmul_macs": float(rng.integers(1, 100)) * 1e8,
             "shiftadd_ops": float(rng.integers(0, 100)) * 1e5,
             "stream_bytes": float(rng.integers(1, 100)) * 1e6,
             "band_steps": float(rng.integers(1, 64)),
             "tile_steps": float(rng.integers(1, 256)),
             "steps": float(rng.integers(1, 64))}
        y = float(np.array([f[k] for k in tcm.ROLLOUT_FEATURES] + [1.0])
                  @ true)
        samples.append(("cuda", f, y))
    model = tcm.fit_rollout_cost(samples, platform="cuda")
    assert model.platform == "cuda"
    for _bk, f, y in samples:
        assert abs(model.predict("cuda", f) - y) <= 0.05 * y + 1e-6
    rt = tcm.RolloutCostModel.from_dict(model.as_dict())
    assert rt.platform == "cuda"
    for bk in ("torch", "cuda"):
        assert rt.predict(bk, samples[0][1]) == model.predict(
            bk, samples[0][1])
    with pytest.raises(KeyError, match="xla"):
        model.predict("xla", samples[0][1])


def test_features_price_the_regime():
    """Pipelined re-streams weights every step; resident pays once."""
    _jp, tp = _plans(MATRICES[0])
    res = specialize_summary(tp, "int8", vmem_budget=None)
    pipe = specialize_summary(tp, "int8", vmem_budget=BUDGETS[2])
    assert (res["regime"], pipe["regime"]) == ("resident", "pipelined")
    f_res = tcm.rollout_cost_features(res, tp.block, 8, steps=16)
    f_pipe = tcm.rollout_cost_features(pipe, tp.block, 8, steps=16)
    assert f_pipe["stream_bytes"] > f_res["stream_bytes"]
    assert f_pipe["band_steps"] > f_res["band_steps"]
    assert f_res["matmul_macs"] == f_pipe["matmul_macs"]


@pytest.mark.parametrize("mode,budget", [("fp32", None), ("int8", None),
                                         ("int8", 40960)])
@pytest.mark.parametrize("resident", [True, False])
def test_rollout_roofline_terms_on_the_h100(mode, budget, resident):
    """Compute: MACs at the int8 tensor-core or fp32 CUDA-core peak plus
    shift-add digits at the shared-memory atomic rate; memory: the
    shares' bytes (folded tiles, 4 bytes per digit) over HBM, once per
    call if resident, else per step, whatever the budget's regime; the
    bound is the larger."""
    _jp, tp = _plans(("pn", 0.97, 32))
    s = specialize_summary(tp, mode, vmem_budget=budget)
    r = roofline.rollout_roofline(s, tp.block, batch=8, steps=64,
                                  resident=resident)
    f = tcm.rollout_cost_features(s, tp.block, 8, 64)
    peak = 67e12 if mode == "fp32" else 1979e12
    assert roofline.SHIFTADD_OPS == 32 * 132 * 1.98e9
    assert r["compute_s"] == pytest.approx(
        2 * f["matmul_macs"] / peak
        + f["shiftadd_ops"] / roofline.SHIFTADD_OPS, rel=1e-15)
    share = (s["n_matmul_terms"] * tp.block ** 2 * (4 if mode == "fp32"
                                                    else 1)
             + 4 * s["shiftadd_digits"])
    assert r["memory_s"] == pytest.approx(
        share * (1 if resident else 64) / 3.35e12, rel=1e-15)
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"])
    assert r["dominant"] in ("compute", "memory") and r["advice"]
    assert "budget" not in r["advice"]
    if mode == "int8":
        assert s["shiftadd_digits"] > 0
        assert s["regime"] == ("resident" if budget is None
                               else "pipelined")
        # the band budget's regime moves no byte on the card
        other = specialize_summary(tp, mode, vmem_budget=(
            40960 if budget is None else None))
        assert roofline.rollout_roofline(
            other, tp.block, batch=8, steps=64,
            resident=resident)["memory_s"] == r["memory_s"]
