"""Parity of the port's offline compile and ESN core with the JAX package.

Bit for bit where the arithmetic is exact: CSD digits, digit planes, the
quantized matrix and its scale, block structure, dequantized tiles, the
exact integer digit-plane product, the random reservoir and input weights.
To a stated tolerance where two frameworks' float math differs (tanh,
matmul accumulation order, the ridge solve's Gram statistics).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplanes as jbp
from repro.core import csd as jcsd
from repro.core import esn as jesn
from repro.core.sparse import FixedMatrix as JFixedMatrix
from repro.core.sparse import random_sparse_matrix as j_random_sparse
from repro_torch.core import bitplanes as tbp
from repro_torch.core import csd as tcsd
from repro_torch.core import esn as tesn
from repro_torch.core.sparse import FixedMatrix, random_sparse_matrix

CPU = "cpu"


def _compile_both(mode="csd", es=0.9, dim=256, block=64, seed=0):
    rng = np.random.default_rng(seed)
    ref = JFixedMatrix.compile(j_random_sparse(dim, dim, es, rng) * 0.05,
                               weight_bits=8, mode=mode, block=block, rng=rng)
    rng = np.random.default_rng(seed)
    port = FixedMatrix.compile(random_sparse_matrix(dim, dim, es, rng) * 0.05,
                               weight_bits=8, mode=mode, block=block, rng=rng)
    return ref, port


@pytest.mark.parametrize("width", [4, 7, 8])
def test_csd_transform_identical(width):
    """Same generator -> same coin flips -> same digits (exact)."""
    vals = np.random.default_rng(width).integers(0, 1 << width, (40, 30))
    a = jcsd.csd_transform(vals, width, np.random.default_rng(1))
    b = tcsd.csd_transform(vals, width, np.random.default_rng(1))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["pn", "csd"])
def test_decompose_identical(mode):
    m = np.random.default_rng(2).integers(-128, 128, (64, 48))
    a = jbp.decompose(m, 8, mode=mode, rng=np.random.default_rng(3))
    b = tbp.decompose(m, 8, mode=mode, rng=np.random.default_rng(3))
    np.testing.assert_array_equal(a.pos, b.pos)
    np.testing.assert_array_equal(a.neg, b.neg)
    assert a.ones == b.ones


@pytest.mark.parametrize("mode,es,block", [("csd", 0.9, 64), ("pn", 0.9, 64),
                                           ("csd", 0.97, 32)])
def test_fixed_matrix_compile_identical(mode, es, block):
    ref, port = _compile_both(mode, es, block=block)
    assert port.scale == ref.scale
    np.testing.assert_array_equal(port.q, np.asarray(ref.q))
    np.testing.assert_array_equal(port.planes.pos, ref.planes.pos)
    np.testing.assert_array_equal(port.planes.neg, ref.planes.neg)
    np.testing.assert_array_equal(port.blocks.mask, ref.blocks.mask)
    np.testing.assert_array_equal(port.blocks.block_rows,
                                  ref.blocks.block_rows)
    np.testing.assert_array_equal(port.blocks.block_cols,
                                  ref.blocks.block_cols)
    np.testing.assert_array_equal(port.blocks.data,
                                  np.asarray(ref.blocks.data))
    assert port.element_sparsity == ref.element_sparsity
    assert (dataclasses.asdict(port.fpga_cost())
            == dataclasses.asdict(ref.fpga_cost()))


def test_matvec_int_exact_is_exact():
    ref, port = _compile_both()
    xq = np.random.default_rng(4).integers(-128, 128, (5, 256))
    want = np.asarray(ref.matvec_int_exact(jnp.asarray(xq, jnp.int32)))
    got = port.matvec_int_exact(torch.as_tensor(xq, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        port.matvec_int_dense_ref(torch.as_tensor(xq)).numpy(), want)


def test_matmul_within_fp32_tolerance():
    """Block-culled float product; accumulation order differs (1e-5)."""
    ref, port = _compile_both()
    x = np.random.default_rng(5).standard_normal((3, 256)).astype(np.float32)
    want = np.asarray(ref.matmul(jnp.asarray(x)))
    np.testing.assert_allclose(port.matmul(torch.as_tensor(x)).numpy(), want,
                               atol=1e-5)
    np.testing.assert_array_equal(port.dense_f32().numpy(),
                                  np.asarray(ref.dense_f32()))


def _configs():
    return [dict(reservoir_dim=256, mode="int8-csd", block=64,
                 element_sparsity=0.9, input_dim=2, output_dim=2, leak=0.6),
            dict(reservoir_dim=200, mode="fp32", block=64,
                 element_sparsity=0.8, input_dim=1, output_dim=1)]


@pytest.mark.parametrize("kw", _configs(), ids=["int8-csd", "fp32"])
def test_init_esn_same_weights(kw):
    ref = jesn.init_esn(jesn.ESNConfig(**kw))
    port = tesn.init_esn(tesn.ESNConfig(**kw), device=CPU)
    np.testing.assert_array_equal(port.w.q, np.asarray(ref.w.q))
    np.testing.assert_array_equal(port.w.planes.pos, ref.w.planes.pos)
    np.testing.assert_array_equal(port.w_in.numpy(), np.asarray(ref.w_in))
    assert port.w.scale == ref.w.scale


def test_spectral_rescale_repeatable_at_dim_1024():
    """A seed fixes the weights: on a dim-1024, 95 %-sparse reservoir whose
    top moduli lie within 1 % (seed 2; ARPACK from a random start with 20
    Lanczos vectors stopped 1.2 % low here), two solves agree bit for bit
    and hit the dense eigensolver's radius to 1e-9."""
    m = random_sparse_matrix(1024, 1024, 0.95, np.random.default_rng(2))
    a = tesn._spectral_rescale(m, 0.9, seed=2)
    np.testing.assert_array_equal(tesn._spectral_rescale(m, 0.9, seed=2), a)
    rho = np.abs(np.linalg.eigvals(a)).max()
    assert abs(rho - 0.9) < 1e-9


def _carry(ref, device=CPU, w_out=True):
    """The reference's ESNParams handed over as numpy (weight carry)."""
    cfg = tesn.ESNConfig(**dataclasses.asdict(ref.config))
    return tesn.params_from_numpy(
        q=np.asarray(ref.w.q), scale=ref.w.scale, pos=ref.w.planes.pos,
        neg=ref.w.planes.neg, block_mask=ref.w.blocks.mask,
        w_in=np.asarray(ref.w_in),
        w_out=None if (ref.w_out is None or not w_out)
        else np.asarray(ref.w_out), config=cfg, device=device)


def test_params_from_numpy_round_trip():
    """Carried weights equal the originals bit for bit — without re-running
    CSD — and a compile artefact that disagrees is refused."""
    ref = jesn.init_esn(jesn.ESNConfig(**_configs()[0]))
    ref = dataclasses.replace(ref, w_out=jnp.asarray(
        np.random.default_rng(0).uniform(-1, 1, (256, 2)), jnp.float32))
    port = _carry(ref)
    np.testing.assert_array_equal(port.w.q, np.asarray(ref.w.q))
    np.testing.assert_array_equal(port.w.planes.pos, ref.w.planes.pos)
    np.testing.assert_array_equal(port.w.planes.neg, ref.w.planes.neg)
    np.testing.assert_array_equal(port.w.blocks.data,
                                  np.asarray(ref.w.blocks.data))
    np.testing.assert_array_equal(port.w_out.numpy(), np.asarray(ref.w_out))
    assert port.w.mode == ref.w.mode and port.w.scale == ref.w.scale
    # and back: the port's own compile carries into a second port params
    again = tesn.params_from_numpy(
        q=port.w.q, scale=port.w.scale, pos=port.w.planes.pos,
        neg=port.w.planes.neg, block_mask=port.w.blocks.mask,
        w_in=port.w_in.numpy(), w_out=port.w_out.numpy(),
        config=port.config, device=CPU)
    np.testing.assert_array_equal(again.w.blocks.data, port.w.blocks.data)
    bad_mask = ~np.asarray(ref.w.blocks.mask)
    with pytest.raises(ValueError, match="block_mask"):
        tesn.params_from_numpy(
            q=np.asarray(ref.w.q), scale=ref.w.scale, pos=ref.w.planes.pos,
            neg=ref.w.planes.neg, block_mask=bad_mask,
            w_in=np.asarray(ref.w_in), w_out=None, config=port.config,
            device=CPU)


def test_int8_step_recurrent_product_exact():
    """One int8 step from the reference's own x(t-1): the int32 recurrent
    product is exact, the float step within 1e-6 (tanh may differ by an
    ulp between the frameworks)."""
    ref = jesn.init_esn(jesn.ESNConfig(**_configs()[0]))
    port = _carry(ref)
    rng = np.random.default_rng(6)
    u = rng.standard_normal((12, 2)).astype(np.float32)
    states = np.asarray(jesn.run_reservoir(ref, jnp.asarray(u),
                                           engine="scan"))
    smax = 127
    for t in range(1, 12):
        x = states[t - 1]
        xq = np.clip(np.round(x * smax), -smax - 1, smax).astype(np.int32)
        want = np.asarray(ref.w.matvec_int_exact(jnp.asarray(xq)))
        xq_t = torch.clamp(torch.round(torch.tensor(x) * smax),
                           -smax - 1, smax).to(torch.int32)
        np.testing.assert_array_equal(xq_t.numpy(), xq)
        np.testing.assert_array_equal(
            port.w.matvec_int_exact(xq_t).numpy(), want)
        step = tesn._step_int8(port, torch.tensor(x)[None],
                               torch.as_tensor(u[t])[None])
        np.testing.assert_allclose(step[0].numpy(), states[t], atol=1e-6)


@pytest.mark.parametrize("kw", _configs(), ids=["int8-csd", "fp32"])
def test_scan_rollout_within_tolerance(kw):
    """Whole trajectories over T=12: within 1e-5 (a 1-ulp tanh difference
    can flip one requantization step in int8; at this T and seed none
    does)."""
    ref = jesn.init_esn(jesn.ESNConfig(**kw))
    port = _carry(ref)
    u = np.random.default_rng(7).standard_normal(
        (3, 12, kw["input_dim"])).astype(np.float32)
    want = np.asarray(jesn.run_reservoir(ref, jnp.asarray(u), engine="scan"))
    got = tesn.run_reservoir(port, torch.as_tensor(u), engine="scan")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_fit_readout_and_nrmse_match_reference():
    """Ridge fit with per-sequence washout on the same states: the Gram
    sums run in float32 in two frameworks and the solve in float64, so the
    fitted readouts' predictions agree to 1e-4 and the NRMSEs to 1e-4."""
    kw = _configs()[1]
    ref = jesn.init_esn(jesn.ESNConfig(**kw))
    port = _carry(ref)
    rng = np.random.default_rng(8)
    u = rng.standard_normal((2, 150, 1)).astype(np.float32)
    y = np.roll(u, 1, axis=1)
    s_ref = jesn.run_reservoir(ref, jnp.asarray(u), engine="scan")
    s_port = torch.as_tensor(np.array(s_ref))
    ref = jesn.fit_readout(ref, s_ref, jnp.asarray(y), lam=1e-1, washout=10)
    port = tesn.fit_readout(port, s_port, torch.as_tensor(y), lam=1e-1,
                            washout=10)
    p_ref = np.asarray(jesn.predict(ref, s_ref))
    p_port = tesn.predict(port, s_port)
    np.testing.assert_allclose(p_port.numpy(), p_ref, atol=1e-4)
    e_ref = float(jesn.nrmse(jnp.asarray(p_ref), jnp.asarray(y)))
    e_port = float(tesn.nrmse(p_port, torch.as_tensor(y)))
    assert abs(e_ref - e_port) < 1e-4


def test_entry_points_refuse_missing_gpu():
    """No device -> cuda; without a card that raises instead of quietly
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tesn.init_esn(tesn.ESNConfig(reservoir_dim=64, block=32))
