"""Pathak et al.'s Kuramoto-Sivashinsky reservoir (``esn9000-io64-csd``:
dim 9,000, 3 links a node, 64 inputs and 64 outputs, int8-CSD) on the CPU.

At dim 1,000 and the same degree every tile holds a few nonzeros, so the
product is shift-add digits alone: the benchmark's engine and the cuda
backend's plain twin against the benchmark's plain reference
(``bench/reference/esn.py``, plain PyTorch, loaded by path); the shares of
the grid of one block a column block (128 columns, the dense form with no
tiles, the ``shared`` readout) decoded as the kernel reads them; the
published shape's grid under an H100's capacity; and the counting
functions of the kernels layer's counters.
"""

import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.esn import ESNConfig, ESNParams
from repro_torch.core.sparse import FixedMatrix
from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
    blocks_per_sm, build_tables, io_macs, launch_counts,
    plain_recurrent_product, plan_grid, readout_path, smem_bytes)
from repro_torch.plan.specialize import SA
from repro_torch.serve import ReservoirEngine, SubmitSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = ROOT / "bench" / "configs" / "esn9000-io64-csd.json"
SEED = 3_000_000_019
DIM = 1000


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # a dataclass looks its module up
    spec.loader.exec_module(mod)
    return mod


reference = _load("esn9000_reference", ROOT / "bench/reference/esn.py")
weights = _load("esn9000_weights", ROOT / "bench/weights.py")


def h100_capacity(smem: int) -> int:
    """Blocks of ``smem`` bytes an H100 holds at once: 132 SMs of 228 KiB
    (1 KiB of it reserved per block), at most 8 blocks of 256 threads an
    SM, at most 227 KiB a block."""
    if smem > 227 * 1024:
        return 0
    return 132 * min(8, 228 * 1024 // (smem + 1024))


def tree_readout(states: np.ndarray, w_out: np.ndarray, cw: int
                 ) -> np.ndarray:
    """The kernel's readout order in float32: block k's partial over its
    ``cw`` columns ``k cw ..`` (pad columns 0) as one pairwise tree
    (adjacent pairs first), then the blocks' partials added in ascending
    block order.  (T, B, dim) states -> (T, B, O) predictions."""
    t, b, dim = states.shape
    n_blocks = -(-dim // cw)
    xp = np.zeros((t * b, n_blocks * cw), np.float32)
    xp[:, :dim] = states.reshape(t * b, dim)
    wp = np.zeros((n_blocks * cw, w_out.shape[1]), np.float32)
    wp[:dim] = w_out
    out = np.empty((t * b, w_out.shape[1]), np.float32)
    for o in range(w_out.shape[1]):
        v = (xp * wp[:, o]).reshape(t * b, n_blocks, cw)
        while v.shape[2] > 1:
            v = v[:, :, 0::2] + v[:, :, 1::2]
        s = v[:, 0, 0]
        for q in range(1, n_blocks):
            s = s + v[:, q, 0]
        out[:, o] = s
    return out.reshape(t, b, -1)


@pytest.fixture(scope="module")
def cfg():
    c = json.loads(CONFIG.read_text())
    c.update(reservoir_dim=DIM, element_sparsity=1 - 3 / DIM)
    return c


@pytest.fixture(scope="module")
def engines(cfg):
    """The seed's weights at dim 1,000, and the engine the benchmark
    builds over them (``bench/harness.py``'s ``build_program``: on the CPU
    ``"auto"`` is the torch backend) beside the cuda backend's (B2's plain
    twin)."""
    w = weights.make_weights(cfg, SEED, "cpu")
    keys = ("reservoir_dim", "input_dim", "output_dim", "element_sparsity",
            "spectral_radius", "input_scale", "leak", "weight_bits",
            "state_bits", "mode", "block")
    ecfg = ESNConfig(**{k: cfg[k] for k in keys}, seed=SEED % (1 << 32))
    fm = FixedMatrix.compile(w.dense, weight_bits=cfg["weight_bits"],
                             mode=ecfg.digit_mode, block=cfg["block"],
                             rng=np.random.default_rng(SEED))
    params = ESNParams(w=fm, w_in=torch.as_tensor(w.w_in),
                       w_out=torch.as_tensor(w.w_out), config=ecfg)
    auto = ReservoirEngine(params, backend="auto", device="cpu")
    b2 = ReservoirEngine(params, backend="cuda", device="cpu")
    return w, {"auto": auto, "cuda": b2}


def _inputs(lengths=(40, 17, 64)):
    rng = np.random.default_rng(0)
    return [rng.uniform(-1, 1, (t, 64)).astype(np.float32) for t in lengths]


def _reference_steps(cfg, w, u, states):
    """Each step of the reference's Eq. 1 from the program's own previous
    state, in float64 around the exact integer product of the reference's
    quantized matrix and requantized state, and Eq. 2 of the program's
    states: (T, dim) states and (T, O) predictions."""
    q, scale = reference.quantize(w.dense, cfg["weight_bits"])
    smax = (1 << (cfg["state_bits"] - 1)) - 1
    x = np.vstack([np.zeros((1, states.shape[1]), np.float32), states[:-1]])
    # the port's float32 x * smax, rounded half to even
    xq = np.clip(np.round(x * np.float32(smax)), -smax - 1, smax).astype(
        np.float64)
    pre = u.astype(np.float64) @ w.w_in.astype(np.float64) + (
        xq @ q) * (scale / smax)
    return np.tanh(pre), states.astype(np.float64) @ w.w_out.astype(
        np.float64)


@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_engines_agree_with_the_reference_at_dim_1000(cfg, engines,
                                                      backend):
    """Every step from the engine's previous state agrees with the
    reference's within 1e-5 of the answers' scale, and so do the
    predictions: the reference works in float64 and the port in float32
    around the same exact integer product.  Run free over 64 steps, two
    float32 roundings may put a requantized state on either side of a
    boundary and part the trajectories by a step of quantization noise,
    which the benchmark's ``pred_err`` limit allows for; teacher-forced,
    no step inherits that.  At 3 links a node no tile reaches the
    crossover: no MM term, every nonzero's CSD digits shift-adds."""
    w, eng = engines
    eng = eng[backend]
    if backend == "cuda":
        assert eng.program.n_matmul_terms == 0
        assert eng.program.shiftadd_digits > 0
    for u in _inputs():
        states = np.asarray(eng.submit(SubmitSpec(u, want_states=True))
                            .states, np.float32)
        preds = eng.predictions(u).numpy()
        x_ref, y_ref = _reference_steps(cfg, w, u, states)
        np.testing.assert_allclose(states, x_ref, rtol=0, atol=1e-5)
        scale = np.abs(y_ref).max()
        np.testing.assert_allclose(preds, y_ref, rtol=0, atol=1e-5 * scale)


def test_free_run_stays_within_the_benchmark_limit(cfg, engines):
    """Free-running, both engines stay within a tenth of the
    configuration's ``pred_err`` limit of the reference's own rollout
    (largest gap over its RMS prediction): the reference's whole
    trajectory, not only its steps."""
    w, eng = engines
    inputs = _inputs()
    spec = {k: cfg[k] for k in ("mode", "weight_bits", "state_bits", "leak")}
    refs = reference.rollout(spec, w.dense, w.w_in, w.w_out, inputs)
    rms = np.sqrt(np.mean(np.concatenate([r.ravel() for r in refs]) ** 2))
    for e in eng.values():
        gap = max(np.abs(e.predictions(u).numpy() - r).max()
                  for u, r in zip(inputs, refs))
        assert gap / rms < 0.1 * cfg["limits"]["pred_err"]


def _decode_digit_words(tables, shares, xq):
    """The dense form's shares with no MM term, as the kernel reads them:
    each block's uint32 digit words (state row in bits 0-15, column
    within the slice in 16-23, shift in 24-27, sign in 28) scattered as
    +-(xq[:, row] << shift): the int64 product of the (B, rows_pad)
    quantized state."""
    out = np.zeros((xq.shape[0], tables.rows_pad), np.int64)
    for blk in range(shares.n_blocks):
        off, n_mm, n_digits, n_bytes = shares.meta[blk]
        assert n_mm == 0
        words = shares.blob[off:off + n_bytes][:4 * n_digits].view(
            np.uint32).astype(np.int64)
        v = xq[:, words & 0xFFFF] << ((words >> 24) & 0xF)
        v = np.where(words >> 28, -v, v)
        np.add.at(out.T, blk * shares.cw + ((words >> 16) & 0xFF), v.T)
    return out


def test_one_block_a_column_block_digits_and_shared_readout(cfg, engines):
    """The grid of one block a column block, as the published shape's
    default grid is: 8 blocks of 128 columns in the dense form with no
    tiles (the longest column's entries per lane exceed the list rule's
    floor of one MMA unit) and the ``shared`` readout.  Its digit words
    decode to the exact integer product, the last block's 24 pad columns
    to zero, and the readout's tree over 128 columns of the twin's
    states agrees with the reference's Eq. 2 within 1e-5 of the answers'
    scale."""
    w, eng = engines
    b2 = eng["cuda"]
    tables = b2._fused.tables
    ncb = tables.n_col_blocks
    assert (ncb, tables.n_matmul_terms) == (8, 0)
    grid = plan_grid(tables, h100_capacity, ncb)
    assert (grid.n_blocks, grid.cw, grid.form) == (8, 128, "mma")
    assert readout_path(grid.cw) == "shared"
    assert int(grid.shares.meta[:, 2].sum()) == tables.n_digits
    rng = np.random.default_rng(1)
    xq = rng.integers(-128, 128, (3, tables.rows_pad))
    xq[:, DIM:] = 0
    got = _decode_digit_words(tables, grid.shares, xq)
    want = plain_recurrent_product(torch.as_tensor(xq, dtype=torch.int32),
                                   tables).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[:, DIM:].any()
    u = _inputs((64,))[0]
    states = np.asarray(b2.submit(SubmitSpec(u, want_states=True)).states,
                        np.float32)
    preds = tree_readout(states[:, None], w.w_out, grid.cw)[:, 0]
    y_ref = states.astype(np.float64) @ w.w_out.astype(np.float64)
    np.testing.assert_allclose(preds, y_ref, rtol=0,
                               atol=1e-5 * np.abs(y_ref).max())


def _published_tables(seed=34):
    """B2's int8 tables of the published shape without its dense matrix:
    dim 9,000 in 71 column blocks of 128, each of the ~27,000 nonzeros
    (3 a node) a shift-add term of 1-4 CSD digits, no MM term."""
    rng = np.random.default_rng(seed)
    dim, bk = 9000, 128
    nnz = rng.binomial(dim * dim, 3 / dim)
    flat = rng.choice(dim * dim, nnz, replace=False)
    rows, cols = flat // dim, flat % dim
    per_col = [[] for _ in range(71)]
    for ci in range(71):
        sel = cols // bk == ci
        for rb in np.unique(rows[sel] // bk):
            at = sel & (rows // bk == rb)
            digits = tuple(
                (int(r % bk), int(c % bk), int(s), int(sh))
                for r, c in zip(rows[at], cols[at])
                for s, sh in zip(rng.choice([-1, 1], 4),
                                 rng.choice(8, rng.integers(1, 5),
                                            replace=False)))
            per_col[ci].append((SA, int(rb), digits))
    schedules = (tuple((ci, tuple(t)) for ci, t in enumerate(per_col)),)
    return build_tables(schedules, np.zeros((1, 1, bk, bk), np.int8),
                        mode="int8", n_col_blocks=71, device="cpu")


def test_published_shape_grid_is_capped_by_the_state_tile():
    """At dim 9,000 a block stages 16 rows of the 9,088-byte state: its
    base is 170,256 bytes at 128 columns and 157,968 at 64, one block an
    SM either way, so 142 blocks of 64 columns do not fit 132 SMs and the
    default grid is 71 blocks of 128 columns, their digit shares
    resident, the ``shared`` readout, one block an SM."""
    tables = _published_tables()
    assert tables.n_matmul_terms == 0 and tables.n_digits > 50_000
    base = smem_bytes(tables, 128)
    assert base == 16 + 16 * (9088 + 16) + 16 * 128 * 12 == 170_256
    assert h100_capacity(smem_bytes(tables, 64)) == 132 < 142
    grid = plan_grid(tables, h100_capacity)
    assert (grid.n_blocks, grid.cw, grid.form, grid.resident) == (
        71, 128, "mma", True)
    assert grid.smem == base + grid.share_bytes
    assert readout_path(grid.cw) == "shared"
    assert blocks_per_sm(h100_capacity, grid.smem, 132) == 1
    assert launch_counts(grid, 5, 1, 1) == (0, 5 * tables.n_digits, 5)


@pytest.mark.parametrize("steps,batch,readout_steps", [
    (6000, 1, 6000), (64, 16, 16), (7, 3, 0)])
def test_io_macs(steps, batch, readout_steps):
    """The input projection's multiply-adds are steps x rows x dim x I
    in every launch; the readout's readout steps x rows x dim x O, none
    without predictions."""
    assert io_macs(steps, batch, 9000, 64, 64, readout_steps) == (
        steps * batch * 9000 * 64, readout_steps * batch * 9000 * 64)
    assert io_macs(steps, batch, 1000, 3, 2, readout_steps) == (
        steps * batch * 3000, readout_steps * batch * 2000)


@pytest.mark.parametrize("smem,per_sm", [
    (170_256, 1), (112_000, 2), (26_448, 8), (232_449, 0)])
def test_blocks_per_sm(smem, per_sm):
    """The occupancy a grid is planned at: the capacity's blocks over the
    SM count."""
    assert blocks_per_sm(h100_capacity, smem, 132) == per_sm
