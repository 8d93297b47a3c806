"""The CUDA kernels on the card (marked ``gpu``; skipped here).

Run on a machine with an NVIDIA GPU:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
Rollout: each call is one cooperative launch (no per-step or readout
launch); int8 kernel states equal the plain twins' exactly and B1's equal
B2's; fp32 within 1e-4 (another summation order in the tile products:
the kernel splits each output's rows into fixed partial sums over a
block's warps and lanes and reduces them in a fixed tree), and a batch of
16 rows bit for bit its rows launched one at a time; readouts within
1e-4; a donated carry resumes bit for bit.  Bitplane gemv
and the integer BCSR product equal their twins exactly; float BCSR products
and reservoir-step trajectories within 1e-4.  The torch serve backend on
the card: within 1e-4 of the kernels, its int8 products exact, fp32 kept
under a caller's TF32 setting; registry, live swap and fault plan in one
zero-copy pool, bit-exact against the pinned engines.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.sparse import (BlockSparse, FixedMatrix,
                                     random_sparse_matrix)
from repro_torch.kernels.bcsr_matmul.bcsr_matmul import (bcsr_matmul,
                                                         bcsr_matmul_plain)
from repro_torch.kernels.bcsr_matmul.ops import BcsrMatmul
from repro_torch.kernels.bitplane_gemv.bitplane_gemv import (
    bitplane_gemv, bitplane_gemv_plain)
from repro_torch.kernels.bitplane_gemv.ops import BitplaneGemv
from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
    _launch_rollout, build_tables, pack_blocks, readout_path,
    reservoir_rollout, reservoir_rollout_plain, rollout_grid)
from repro_torch.kernels.reservoir_rollout.specialized import (
    SpecializedRollout, specialized_rollout, specialized_rollout_plain)
from repro_torch.kernels.reservoir_step.ops import FusedReservoir
from repro_torch.kernels.reservoir_step.reservoir_step import (
    reservoir_step, reservoir_step_plain)
from repro_torch.plan import specialize_rollout, specialize_summary

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_specialized_kernel_matches_twin(cuda, mode):
    rng = np.random.default_rng(0)
    fm = FixedMatrix.compile(random_sparse_matrix(256, 256, 0.97, rng) * 0.05,
                             weight_bits=8, mode="csd", block=32, rng=rng)
    w_in = rng.uniform(-0.5, 0.5, (3, 256)).astype(np.float32)
    w_out = rng.uniform(-0.1, 0.1, (256, 2)).astype(np.float32)
    op = SpecializedRollout(fm, w_in, leak=0.7, mode=mode, w_out=w_out,
                            device=cuda)
    u = torch.as_tensor(rng.standard_normal((6, 5, 3)).astype(np.float32),
                        device=cuda)
    x0 = torch.zeros((5, 256), device=cuda)
    kw = dict(want_states=True, want_preds=True, want_final=True)
    before = specialized_rollout.launches, specialized_rollout.fused_launches
    s, p, f = op(u, x0, **kw)
    assert (specialized_rollout.launches - before[0],
            specialized_rollout.fused_launches - before[1]) == (1, 1)
    ps, pp, pf = specialized_rollout_plain(
        u, op.tables, op.w_in, x0, op.w_out, leak=op.leak, smax=op.smax,
        recur_scale=op.recur_scale, **kw)
    torch.cuda.synchronize()
    tol = 0.0 if mode == "int8" else 1e-4
    assert (s - ps).abs().max().item() <= tol
    assert (f - pf).abs().max().item() <= tol
    assert (p - pp).abs().max().item() <= 1e-4


# -- B1 and B2: one persistent launch per call --------------------------------
_SPARSE = {}


def _sparse_fm():
    """dim 256, block 32, 97 % zeros: thin digit planes become B2's
    shift-add digits."""
    if not _SPARSE:
        rng = np.random.default_rng(0)
        _SPARSE["fm"] = FixedMatrix.compile(
            random_sparse_matrix(256, 256, 0.97, rng) * 0.05, weight_bits=8,
            mode="csd", block=32, rng=rng)
    return _SPARSE["fm"]


def _pipelined_budget(plan, mode):
    tile = plan.block * plan.block * (4 if mode == "fp32" else 1)
    for n in range(1, 256):
        try:
            s = specialize_summary(plan, mode, vmem_budget=2 * n * tile)
        except ValueError:
            continue
        if s["regime"] == "pipelined":
            return 2 * n * tile
    raise AssertionError("no pipelined budget")


def _run(fn, op, u, x0, b_tile, k, n_blocks=None, **kw):
    """One call of B1 or B2 on the op's tables: (outputs, launches made,
    launches made with the readout fused).  An explicit ``n_blocks``
    launches below the entry point, on that grid."""
    before = fn.launches, fn.fused_launches
    kw.update(leak=op.leak, smax=op.smax, recur_scale=op.recur_scale,
              b_tile=b_tile, readout_every=k)
    if n_blocks is None:
        out = fn(u, op.tables, op.w_in, x0, op.w_out, **kw)
    else:
        out = _launch_rollout(fn, u, op.tables, op.w_in, x0, op.w_out,
                              n_blocks=n_blocks, **kw)
    return out, fn.launches - before[0], fn.fused_launches - before[1]


@pytest.mark.parametrize("batch", [1, 5, 16, 24])
@pytest.mark.parametrize("regime", ["resident", "pipelined"])
@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_rollout_kernels_one_launch_match_twins(cuda, mode, regime, batch):
    """B1 and B2 against their twins over T in {1, 7, 33} with a readout
    every step and T in {8, 32} with one every 4 steps; batch 24 is two
    batch tiles.  One launch per call, the readout fused; int8 exact and
    B1 == B2; a donated carry at T = 1 and T > 1 equals one shot.  B2
    takes no band budget: its shares are byte-identical to those of the
    regime's lowering."""
    fm = _sparse_fm()
    plan = fm.plan()
    rng = np.random.default_rng(batch)
    w_in = rng.uniform(-0.5, 0.5, (3, 256)).astype(np.float32)
    w_out = rng.uniform(-0.1, 0.1, (256, 2)).astype(np.float32)
    budget = None if regime == "resident" else _pipelined_budget(plan, mode)
    b2 = SpecializedRollout(plan, w_in, leak=0.7, mode=mode, w_out=w_out,
                            device=cuda)
    b1 = FusedRollout(plan, w_in, leak=0.7, mode=mode, w_out=w_out,
                      device=cuda)
    prog = specialize_rollout(plan, mode, vmem_budget=budget)
    assert prog.regime == regime and b2.program.vmem_budget is None
    grid, _ = rollout_grid(b2.tables, cuda)
    shares = pack_blocks(build_tables(prog.schedules, prog.data, mode=mode,
                                      n_col_blocks=plan.nbc, device=cuda),
                         grid.n_blocks)
    assert shares.blob.tobytes() == grid.shares.blob.tobytes()
    assert np.array_equal(shares.meta, grid.shares.meta)
    assert mode == "fp32" or b2.tables.n_digits > 0
    tol = 0.0 if mode == "int8" else 1e-4
    kw = dict(want_states=True, want_preds=True, want_final=True)
    for t, k in ((1, 1), (7, 1), (33, 1), (8, 4), (32, 4)):
        u = torch.as_tensor(rng.standard_normal((t, batch, 3)),
                            dtype=torch.float32, device=cuda)
        x0 = torch.as_tensor(0.5 * rng.standard_normal((batch, 256)),
                             dtype=torch.float32, device=cuda)
        got = {}
        for fn, plain, op in ((specialized_rollout,
                               specialized_rollout_plain, b2),
                              (reservoir_rollout, reservoir_rollout_plain,
                               b1)):
            b_tile = op._batch_tile(batch)
            (s, p, f), n, ro = _run(fn, op, u, x0, b_tile, k, **kw)
            assert (n, ro) == (1, 1)
            ps, pp, pf = plain(u, op.tables, op.w_in, x0, op.w_out,
                               leak=op.leak, smax=op.smax,
                               recur_scale=op.recur_scale, readout_every=k,
                               **kw)
            torch.cuda.synchronize()
            assert p.shape == (t // k, batch, 2)
            assert (s - ps).abs().max().item() <= tol
            assert (f - pf).abs().max().item() <= tol
            assert (p - pp).abs().max().item() <= 1e-4
            got[fn] = (s, p, f)
            # the carry donated in place: at T = 1 x0 is read and x(1)
            # written by every block in the same launch
            carry = x0.clone()
            states = []
            for lo, hi in [(0, 1)] + ([(1, t)] if t > 1 else []):
                (cs, cf), n, ro = _run(fn, op, u[lo:hi], carry, b_tile, 1,
                                       want_states=True, want_final=True,
                                       final_out=carry)
                assert (n, ro) == (1, 0) and cf.data_ptr() == carry.data_ptr()
                states.append(cs)
            assert torch.equal(torch.cat(states), s)
            assert torch.equal(carry, f)
        if mode == "int8":
            for a, b in zip(got[specialized_rollout], got[reservoir_rollout]):
                assert torch.equal(a, b)


@pytest.mark.parametrize("mode,n_blocks,form", [
    ("int8", 32, "mma"), ("int8", 128, "mma"), ("fp32", 8, "mma"),
    ("int8", 32, "lists"), ("int8", 128, "lists")])
def test_rollout_kernels_stream_or_keep_tiles(cuda, monkeypatch, mode,
                                              n_blocks, form):
    """dim 1024, block 128 (LARGE_1024's shape).  Dense int8 tiles (the
    rule's constant at 0): at 32 blocks B1's share (256 KiB), and at 8
    blocks its fp32 share (512 KiB), exceed shared memory and stream from
    global memory every step; at 128 blocks both kernels keep theirs
    resident.  The list form (the constant at infinity) on a capacity
    that holds the blocks only without their shares: both kernels read
    their lists from global memory every step.  Either way B1 and B2 match
    their twins (and each other in int8), and a non-default grid is one
    launch too."""
    from repro_torch.kernels.reservoir_rollout import reservoir_rollout as rr
    monkeypatch.setattr(rr, "_LISTS_PER_MMA_UNIT",
                        0.0 if form == "mma" else float("inf"))
    if form == "lists":
        # room for every block's footprint without its share (smem_bytes:
        # the mbarrier, 16 int8 state rows of 1,040 bytes, 12 bytes per
        # output) and no more
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        base = 16 + 16 * 1040 + 16 * (1024 // n_blocks) * 12
        monkeypatch.setattr(rr, "_device_capacity", lambda int8, dev: (
            lambda smem: sms if smem <= base else 0))
    rng = np.random.default_rng(n_blocks)
    fm = FixedMatrix.compile(random_sparse_matrix(1024, 1024, 0.95, rng)
                             * 0.05, weight_bits=8, mode="csd", block=128,
                             rng=rng)
    w_in = rng.uniform(-0.5, 0.5, (1, 1024)).astype(np.float32)
    w_out = rng.uniform(-0.1, 0.1, (1024, 1)).astype(np.float32)
    u = torch.as_tensor(rng.standard_normal((16, 16, 1)),
                        dtype=torch.float32, device=cuda)
    x0 = torch.as_tensor(0.5 * rng.standard_normal((16, 1024)),
                         dtype=torch.float32, device=cuda)
    kw = dict(want_states=True, want_preds=True, want_final=False)
    got = []
    for fn, plain, cls in ((reservoir_rollout, reservoir_rollout_plain,
                            FusedRollout),
                           (specialized_rollout, specialized_rollout_plain,
                            SpecializedRollout)):
        op = cls(fm, w_in, leak=0.3, mode=mode, w_out=w_out, device=cuda)
        grid, _ = rollout_grid(op.tables, cuda, n_blocks)
        assert grid.form == form
        if form == "lists":
            assert not grid.resident
        elif fn is reservoir_rollout:
            assert grid.resident is (n_blocks == 128)
        (s, p), n, ro = _run(fn, op, u, x0, 16, 1, n_blocks=n_blocks, **kw)
        assert (n, ro) == (1, 1)
        ps, pp = plain(u, op.tables, op.w_in, x0, op.w_out, leak=op.leak,
                       smax=op.smax, recur_scale=op.recur_scale, **kw)
        torch.cuda.synchronize()
        tol = 0.0 if mode == "int8" else 1e-4
        assert (s - ps).abs().max().item() <= tol
        assert (p - pp).abs().max().item() <= 1e-4
        got.append((s, p))
    if mode == "int8":
        assert torch.equal(got[0][0], got[1][0])
        assert torch.equal(got[0][1], got[1][1])


def test_rollout_launch_too_large_raises(cuda):
    """fp32 at dim 2048: one 16-row state tile takes 128 KiB, so an SM
    holds one block.  The default grid fits the card and runs; 256 blocks
    of 8 columns do not, and the cooperative launch refuses: the wrapper
    raises and counts nothing (no per-step fallback), and the refusal
    does not linger: the next launch runs and reports success."""
    rng = np.random.default_rng(0)
    fm = FixedMatrix.compile(random_sparse_matrix(2048, 2048, 0.99, rng)
                             * 0.05, weight_bits=8, mode="csd", block=128,
                             rng=rng)
    op = SpecializedRollout(fm, np.zeros((1, 2048), np.float32), mode="fp32",
                            device=cuda)
    u = torch.zeros((2, 4, 1), device=cuda)
    x0 = torch.zeros((4, 2048), device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    grid, _ = rollout_grid(op.tables, cuda)
    assert grid.n_blocks <= sms
    s, n, ro = _run(specialized_rollout, op, u, x0, 4, 1, want_states=True)
    torch.cuda.synchronize()
    assert (n, ro) == (1, 0) and torch.equal(s, torch.zeros_like(s))
    before = specialized_rollout.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        _run(specialized_rollout, op, u, x0, 4, 1, n_blocks=256,
             want_states=True)
    assert specialized_rollout.launches == before
    s, n, ro = _run(specialized_rollout, op, u, x0, 4, 1, want_states=True)
    torch.cuda.synchronize()
    assert (n, ro) == (1, 0) and torch.equal(s, torch.zeros_like(s))


@pytest.mark.parametrize("n_blocks", [None, 7])
@pytest.mark.parametrize("cls", [FusedRollout, SpecializedRollout])
def test_fp32_rollout_rows_independent_of_batch(cuda, cls, n_blocks):
    """The fp32 branch at PAPER_BASELINE's shape (dim 800, block 128, 75 %
    of elements zero, all 49 blocks kept): every output's sum order is set
    by the grid and the table alone, so one launch of 16 rows gives, row
    by row, the same states, predictions and final state bit for bit as
    16 launches of one row each, and as launches of 2, 3, 5 and 6 rows
    (the kernel's 2-, 4- and 8-row accumulator sets).  On the default grid
    (112 blocks of 8 columns, shares resident) and on 7 blocks of 128
    columns (shares streamed); both within 1e-4 of the plain twin."""
    from repro_torch.configs.esn_paper import PAPER_BASELINE
    from repro_torch.core.esn import init_esn
    params = init_esn(PAPER_BASELINE, device=cuda)
    rng = np.random.default_rng(29)
    w_out = rng.uniform(-0.1, 0.1, (800, 2)).astype(np.float32)
    op = cls(params.w.plan(), params.w_in, leak=0.3, mode="fp32",
             w_out=w_out, device=cuda)
    fn = (reservoir_rollout if cls is FusedRollout
          else specialized_rollout)
    plain = (reservoir_rollout_plain if cls is FusedRollout
             else specialized_rollout_plain)
    assert (op.tables.n_col_blocks, op.tables.block,
            op.tables.n_matmul_terms) == (7, 128, 49)
    grid, _ = rollout_grid(op.tables, cuda, n_blocks)
    assert (grid.n_blocks, grid.cw, grid.resident) == (
        (112, 8, True) if n_blocks is None else (7, 128, False))
    t, b = 24, 16
    u = torch.as_tensor(rng.standard_normal((t, b, params.w_in.shape[0])),
                        dtype=torch.float32, device=cuda)
    x0 = torch.as_tensor(0.5 * rng.standard_normal((b, 800)),
                         dtype=torch.float32, device=cuda)
    kw = dict(want_states=True, want_preds=True, want_final=True)
    (s, p, f), n, ro = _run(fn, op, u, x0, b, 1, n_blocks=n_blocks, **kw)
    assert (n, ro) == (1, 1)
    rows = [(i, i + 1) for i in range(b)] + [(0, 2), (2, 5), (5, 10),
                                             (10, 16)]
    for lo, hi in rows:
        (s1, p1, f1), n, ro = _run(fn, op, u[:, lo:hi], x0[lo:hi], hi - lo,
                                   1, n_blocks=n_blocks, **kw)
        assert (n, ro) == (1, 1)
        assert torch.equal(s1, s[:, lo:hi])
        assert torch.equal(p1, p[:, lo:hi])
        assert torch.equal(f1, f[lo:hi])
    ps, pp, pf = plain(u, op.tables, op.w_in, x0, op.w_out, leak=op.leak,
                       smax=op.smax, recur_scale=op.recur_scale, **kw)
    torch.cuda.synchronize()
    assert (s - ps).abs().max().item() <= 1e-4
    assert (f - pf).abs().max().item() <= 1e-4
    assert (p - pp).abs().max().item() <= 1e-4


@pytest.mark.parametrize("n_blocks,cw", [(32, 8), (16, 16), (8, 32),
                                         (4, 64)])
@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_fused_readout_tree_is_repeatable(cuda, mode, n_blocks, cw):
    """The fused readout's pairwise tree over a block's cw columns, in
    registers (cw 8, 16, 32) and through shared memory (cw 64), on
    explicit grids at dim 256, block 128, two outputs: predictions within
    1e-4 of the twin, one launch with its readout fused per call, and the
    same bits in two runs, for rows launched alone (batch 1) or 16
    together, and for T split into two chunks that carry the state.  In
    int8 B1's predictions equal B2's."""
    rng = np.random.default_rng(cw)
    fm = FixedMatrix.compile(random_sparse_matrix(256, 256, 0.95, rng) * 0.05,
                             weight_bits=8, mode="csd", block=128, rng=rng)
    w_in = rng.uniform(-0.5, 0.5, (2, 256)).astype(np.float32)
    w_out = rng.uniform(-0.1, 0.1, (256, 2)).astype(np.float32)
    b2 = SpecializedRollout(fm, w_in, leak=0.6, mode=mode, w_out=w_out,
                            device=cuda)
    grid, _ = rollout_grid(b2.tables, cuda, n_blocks)
    assert (grid.n_blocks, grid.cw) == (n_blocks, cw)
    assert readout_path(cw) == ("shuffle" if cw <= 32 else "shared")
    t, split = 24, 10
    u = torch.as_tensor(rng.standard_normal((t, 16, 2)),
                        dtype=torch.float32, device=cuda)
    x0 = torch.as_tensor(0.5 * rng.standard_normal((16, 256)),
                         dtype=torch.float32, device=cuda)
    kw = dict(want_states=False, want_preds=True, want_final=True)

    def run(u, x0, fn=specialized_rollout, op=b2):
        (p, f), n, ro = _run(fn, op, u, x0, u.shape[1], 1,
                             n_blocks=n_blocks, **kw)
        assert (n, ro) == (1, 1)
        return p, f

    p, _f = run(u, x0)
    assert torch.equal(run(u, x0)[0], p)
    for lo, hi in ((0, 1), (7, 8), (15, 16), (0, 16)):
        if hi - lo == 1:
            assert torch.equal(run(u[:, lo:hi], x0[lo:hi])[0], p[:, lo:hi])
        pa, fa = run(u[:split, lo:hi], x0[lo:hi])
        pb, _fb = run(u[split:, lo:hi], fa)
        assert torch.equal(torch.cat([pa, pb]), p[:, lo:hi])
    pp = specialized_rollout_plain(
        u, b2.tables, b2.w_in, x0, b2.w_out, leak=b2.leak, smax=b2.smax,
        recur_scale=b2.recur_scale, want_states=False, want_preds=True)
    torch.cuda.synchronize()
    assert p.shape == (t, 16, 2) and p.abs().max().item() > 0.01
    assert (p - pp).abs().max().item() <= 1e-4
    if mode == "int8":
        b1 = FusedRollout(fm, w_in, leak=0.6, mode=mode, w_out=w_out,
                          device=cuda)
        assert torch.equal(run(u, x0, reservoir_rollout, b1)[0], p)


_LARGEST = {}


def _esn4096_fm():
    """The paper's largest reservoir's shape (``esn4096-csd98``): dim
    4,096, 98 % of elements zero, block 128, int8-CSD; a seeded draw
    scaled near spectral radius 0.9.  All 1,024 blocks are folded tiles,
    the CSD top plane's digits shift-adds."""
    if not _LARGEST:
        rng = np.random.default_rng(30)
        _LARGEST["fm"] = FixedMatrix.compile(
            random_sparse_matrix(4096, 4096, 0.98, rng) * 0.17,
            weight_bits=8, mode="csd", block=128, rng=rng)
        _LARGEST["w_in"] = rng.uniform(-0.5, 0.5, (1, 4096)).astype(
            np.float32)
        _LARGEST["w_out"] = (rng.standard_normal((4096, 1)) / 64).astype(
            np.float32)
    return _LARGEST["fm"], _LARGEST["w_in"], _LARGEST["w_out"]


def _esn4096_op(cuda):
    fm, w_in, w_out = _esn4096_fm()
    op = SpecializedRollout(fm, w_in, mode="int8", w_out=w_out, device=cuda)
    assert (op.tables.n_matmul_terms, op.program.crossover) == (1024, 64)
    assert op.tables.n_digits > 30_000
    return op


def _one_shot_and_chunks_match_twin(op, fn, plain, cuda, batch, t, split,
                                    seed):
    """One launch of ``fn`` on the op's default grid against its plain
    twin, bit for bit in states and final state (predictions within
    1e-4); then the same T in two chunks resuming from a carry donated in
    place, equal to the one shot.  Returns the one shot's outputs."""
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(-1, 1, (t, batch, op.w_in.shape[0])),
                        dtype=torch.float32, device=cuda)
    x0 = torch.as_tensor(0.5 * rng.standard_normal((batch, op.dim)),
                         dtype=torch.float32, device=cuda)
    kw = dict(want_states=True, want_preds=True, want_final=True)
    b_tile = op._batch_tile(batch)
    (s, p, f), n, ro = _run(fn, op, u, x0, b_tile, 1, **kw)
    assert (n, ro) == (1, 1)
    ps, pp, pf = plain(u, op.tables, op.w_in, x0, op.w_out, leak=op.leak,
                       smax=op.smax, recur_scale=op.recur_scale, **kw)
    torch.cuda.synchronize()
    assert s.abs().max().item() > 0.1
    assert torch.equal(s, ps) and torch.equal(f, pf)
    assert (p - pp).abs().max().item() <= 1e-4
    carry = x0.clone()
    chunks = []
    for lo, hi in ((0, split), (split, t)):
        (cs, cf), n, ro = _run(fn, op, u[lo:hi], carry, b_tile, 1,
                               want_states=True, want_final=True,
                               final_out=carry)
        assert (n, ro) == (1, 0) and cf.data_ptr() == carry.data_ptr()
        chunks.append(cs)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(chunks), s) and torch.equal(carry, f)
    return s, p, f


@pytest.mark.parametrize("batch", [1, 4, 16])
def test_esn4096_default_grid_matches_twin(cuda, batch):
    """dim 4,096 on the default grid (256 blocks of 16 columns), whose
    columns' folded (row, weight) lists -- the MM tiles and the top
    plane's digits in one weight per nonzero -- stay resident: B2 equals
    its plain twin bit for bit in states and final state over an odd
    T = 63, in one launch, and in two chunks with a donated carry.
    Predictions within 1e-4: the kernel sums each block's 16 columns in
    a pairwise tree and the blocks' partials in ascending block order,
    the twin takes one x @ W_out."""
    op = _esn4096_op(cuda)
    grid, _ = rollout_grid(op.tables, cuda)
    assert (grid.n_blocks, grid.cw, grid.form, grid.resident) == (
        256, 16, "lists", True)
    assert grid.shares.meta[:, 2].sum() == 0
    _one_shot_and_chunks_match_twin(op, specialized_rollout,
                                    specialized_rollout_plain, cuda, batch,
                                    63, 40, batch)


@pytest.mark.parametrize("batch", [1, 4, 16])
def test_large_1024_lists_match_twin(cuda, monkeypatch, batch):
    """LARGE_1024 (dim 1,024, 95 % sparse) on the default grid, 128 blocks
    of 8 columns: B1 takes the list form by the rule (its 64 plane terms a
    column block make 8 MMA units a warp against 3 entries a lane), B2
    keeps the dense form (1 unit a warp), and B2 forced into the lists
    (the rule's constant at infinity) runs them too.  Each equals its
    plain twin bit for bit over an odd T = 37 and in chunks with a
    donated carry, and all three equal each other."""
    from repro_torch.configs.esn_paper import LARGE_1024
    from repro_torch.core.esn import init_esn
    from repro_torch.kernels.reservoir_rollout import reservoir_rollout as rr
    params = init_esn(LARGE_1024, device=cuda)
    w_out = np.random.default_rng(11).uniform(-0.1, 0.1, (1024, 2)).astype(
        np.float32)
    got = []
    for cls, fn, plain, form in (
            (SpecializedRollout, specialized_rollout,
             specialized_rollout_plain, "mma"),
            (FusedRollout, reservoir_rollout, reservoir_rollout_plain,
             "lists"),
            (SpecializedRollout, specialized_rollout,
             specialized_rollout_plain, "forced")):
        if form == "forced":
            monkeypatch.setattr(rr, "_LISTS_PER_MMA_UNIT", float("inf"))
        op = cls(params.w, params.w_in, leak=0.8, mode="int8", w_out=w_out,
                 device=cuda)
        grid, _ = rollout_grid(op.tables, cuda)
        assert (grid.n_blocks, grid.cw, grid.resident) == (128, 8, True)
        assert grid.form == ("lists" if form == "forced" else form)
        got.append(_one_shot_and_chunks_match_twin(
            op, fn, plain, cuda, batch, 37, 18, batch))
    for other in got[1:]:
        for a, b in zip(got[0], other):
            assert torch.equal(a, b)


def test_dense_form_table_matches_twin(cuda):
    """A 50 %-sparse int8 table keeps the dense MMA form on its default
    grid, and B2 and B1 on it still equal their twins bit for bit, at
    batch 1 and 5."""
    rng = np.random.default_rng(50)
    fm = FixedMatrix.compile(random_sparse_matrix(512, 512, 0.5, rng) * 0.02,
                             weight_bits=8, mode="csd", block=128, rng=rng)
    w_in = rng.uniform(-0.5, 0.5, (2, 512)).astype(np.float32)
    w_out = rng.uniform(-0.1, 0.1, (512, 2)).astype(np.float32)
    for cls, fn, plain in ((SpecializedRollout, specialized_rollout,
                            specialized_rollout_plain),
                           (FusedRollout, reservoir_rollout,
                            reservoir_rollout_plain)):
        op = cls(fm, w_in, leak=0.7, mode="int8", w_out=w_out, device=cuda)
        grid, _ = rollout_grid(op.tables, cuda)
        assert grid.form == "mma"
        for batch in (1, 5):
            _one_shot_and_chunks_match_twin(op, fn, plain, cuda, batch, 21,
                                            8, batch)


def test_esn4096_rows_independent_of_batch(cuda):
    """A 4-row launch at dim 4,096 equals its rows launched one at a time,
    bit for bit, in states, predictions and final state."""
    op = _esn4096_op(cuda)
    rng = np.random.default_rng(4)
    u = torch.as_tensor(rng.uniform(-1, 1, (64, 4, 1)),
                        dtype=torch.float32, device=cuda)
    x0 = torch.as_tensor(0.5 * rng.standard_normal((4, 4096)),
                         dtype=torch.float32, device=cuda)
    kw = dict(want_states=True, want_preds=True, want_final=True)
    (s, p, f), _n, _ro = _run(specialized_rollout, op, u, x0, 4, 1, **kw)
    for r in range(4):
        (s1, p1, f1), _n, _ro = _run(specialized_rollout, op, u[:, r:r + 1],
                                     x0[r:r + 1], 1, 1, **kw)
        assert torch.equal(s1, s[:, r:r + 1])
        assert torch.equal(p1, p[:, r:r + 1])
        assert torch.equal(f1, f[r:r + 1])


def test_esn4096_counters_read_launch_counts(cuda):
    """With ``obs`` on, a fresh table's first launch records one
    ``rollout_grid`` event (the list form, resident) and adds
    :func:`launch_counts` of its grid to the streamed-bytes, shift-add
    digit and product-row counters: no bytes streamed, no digit
    scattered, steps x rows under ``form="lists"``."""
    from repro_torch import obs
    from repro_torch.kernels.reservoir_rollout.reservoir_rollout import \
        launch_counts
    op = _esn4096_op(cuda)
    u = torch.zeros((16, 2, 1), device=cuda)
    x0 = torch.zeros((2, 4096), device=cuda)
    obs.configure()
    try:
        _run(specialized_rollout, op, u, x0, 2, 1, want_preds=True,
             want_states=False)
        torch.cuda.synchronize()
        (ev,) = obs.events().events("rollout_grid")
        grid, _ = rollout_grid(op.tables, u.device)   # the launch's grid
        m = obs.metrics()
        got = tuple(m.get(name).value(kernel="specialized_rollout")
                    for name in ("rollout_streamed_bytes_total",
                                 "rollout_shiftadd_digits_total")) + (
            m.get("rollout_product_rows_total").value(
                kernel="specialized_rollout", form="lists"),)
    finally:
        obs.disable()
    assert (ev.fields["n_blocks"], ev.fields["resident"], ev.fields["form"],
            ev.fields["list_entries"]) == (grid.n_blocks, True, "lists",
                                           grid.shares.entries)
    assert got == launch_counts(grid, 16, 2, 2) == (0, 0, 16 * 2)


_KS = {}


def _ks_op(cuda, dim, out_dim=64):
    """Pathak et al.'s Kuramoto-Sivashinsky reservoir's shape
    (``esn9000-io64-csd``): 3 links a node, 64 inputs and 64 outputs,
    int8-CSD, block 128; a seeded draw scaled near spectral radius 0.4.
    No tile reaches the crossover: every nonzero's digits are shift-adds.
    ``out_dim`` other than 64 takes the first outputs of a seeded
    (dim, 100) readout."""
    if dim not in _KS:
        rng = np.random.default_rng(34)
        _KS[dim] = (FixedMatrix.compile(
            random_sparse_matrix(dim, dim, 1 - 3 / dim, rng) * 0.4,
            weight_bits=8, mode="csd", block=128, rng=rng),
            rng.uniform(-0.5, 0.5, (64, dim)).astype(np.float32),
            (rng.standard_normal((dim, 64)) / dim ** 0.5).astype(np.float32))
    fm, w_in, w_out = _KS[dim]
    if out_dim != 64:
        w_out = np.ascontiguousarray(
            (np.random.default_rng(35).standard_normal((dim, 100))
             / dim ** 0.5).astype(np.float32)[:, :out_dim])
    op = SpecializedRollout(fm, w_in, mode="int8", w_out=w_out, device=cuda)
    assert op.tables.n_matmul_terms == 0 and op.tables.n_digits > 0
    return op


@pytest.mark.parametrize("n_blocks", [None, 8])
@pytest.mark.parametrize("batch", [1, 16])
def test_ks_io64_matches_twin(cuda, batch, n_blocks):
    """dim 1,000 with 64 inputs and 64 outputs on the default grid (128
    blocks of 8 columns, the list form, the ``shuffle`` readout) and on
    the grid of one block a column block (8 blocks of 128 columns: the
    digit scatter with no tile, the ``shared`` readout, 24 pad columns in
    the last block): B2 equals its plain twin bit for bit in states and
    final state over T = 64, and its predictions equal the readout's
    tree (``tree_readout``: each block's pairwise sum over its columns,
    the blocks added in ascending order) over the twin's states, bit for
    bit."""
    from test_torch_esn9000 import tree_readout
    op = _ks_op(cuda, 1000)
    grid, _ = rollout_grid(op.tables, cuda, n_blocks)
    assert (grid.n_blocks, grid.cw, grid.form) == (
        (128, 8, "lists") if n_blocks is None else (8, 128, "mma"))
    assert readout_path(grid.cw) == ("shuffle" if n_blocks is None
                                     else "shared")
    rng = np.random.default_rng(batch)
    u = torch.as_tensor(rng.uniform(-1, 1, (64, batch, 64)),
                        dtype=torch.float32, device=cuda)
    x0 = torch.zeros((batch, 1000), device=cuda)
    kw = dict(want_states=True, want_preds=True, want_final=True)
    (s, p, f), n, ro = _run(specialized_rollout, op, u, x0,
                            op._batch_tile(batch), 1, n_blocks=n_blocks, **kw)
    assert (n, ro) == (1, 1)
    ps, pp, pf = specialized_rollout_plain(
        u, op.tables, op.w_in, x0, op.w_out, leak=op.leak, smax=op.smax,
        recur_scale=op.recur_scale, **kw)
    torch.cuda.synchronize()
    assert s.abs().max().item() > 0.1
    assert torch.equal(s, ps) and torch.equal(f, pf)
    want = tree_readout(ps.cpu().numpy(), op.w_out.cpu().numpy(), grid.cw)
    assert np.array_equal(p.cpu().numpy(), want)
    assert (p - pp).abs().max().item() <= 1e-4


@pytest.mark.parametrize("out_dim", [1, 3, 64, 100])
@pytest.mark.parametrize("batch", [1, 4, 16, 20])
@pytest.mark.parametrize("n_blocks,cw", [(8, 128), (16, 64)])
def test_ks_wide_readout_matches_the_tree(cuda, n_blocks, cw, batch,
                                          out_dim):
    """The ``shared`` readout (a lane per (output, 32-column chunk)) on
    explicit grids of 128- and 64-column slices at dim 1,000 (24 pad
    columns in the last block), batch tiles of 1, 4 and 16 rows (batch 20:
    a tile of 16 summed before the step barrier's arrival, one of 4 after
    it) and 1, 3, 64 or 100 outputs: B2's states equal its plain twin's
    bit for bit over T = 64, and its predictions equal ``tree_readout``
    over the twin's states bit for bit."""
    from test_torch_esn9000 import tree_readout
    op = _ks_op(cuda, 1000, out_dim)
    grid, _ = rollout_grid(op.tables, cuda, n_blocks)
    assert grid.cw == cw and readout_path(cw) == "shared"
    rng = np.random.default_rng(batch * 1000 + out_dim)
    u = torch.as_tensor(rng.uniform(-1, 1, (64, batch, 64)),
                        dtype=torch.float32, device=cuda)
    x0 = torch.zeros((batch, 1000), device=cuda)
    kw = dict(want_states=True, want_preds=True, want_final=False)
    (s, p), n, ro = _run(specialized_rollout, op, u, x0, min(batch, 16), 1,
                         n_blocks=n_blocks, **kw)
    assert (n, ro) == (1, 1)
    ps, pp = specialized_rollout_plain(
        u, op.tables, op.w_in, x0, op.w_out, leak=op.leak, smax=op.smax,
        recur_scale=op.recur_scale, **kw)
    torch.cuda.synchronize()
    assert p.shape == (64, batch, out_dim) and s.abs().max().item() > 0.1
    assert torch.equal(s, ps)
    want = tree_readout(ps.cpu().numpy(), op.w_out.cpu().numpy(), cw)
    assert np.array_equal(p.cpu().numpy().view(np.uint32),
                          want.view(np.uint32))
    assert (p - pp).abs().max().item() <= 1e-4


def test_wide_readout_at_its_widest_slice(cuda):
    """fp32 at dim 1,056 in one column block: two thread blocks of 528
    columns (17 chunks, a warp's 32 lanes all one output's) give
    predictions equal to ``tree_readout`` over B2's own states bit for
    bit, each block's tree zero-padded to 1,024 leaves; one block of all
    1,056 columns is wider than a warp's chunks, and the launch refuses it
    before it runs."""
    from test_torch_esn9000 import tree_readout
    dim, cw = 1056, 528
    rng = np.random.default_rng(35)
    fm = FixedMatrix.compile(random_sparse_matrix(dim, dim, 0.99, rng)
                             * 0.05, weight_bits=8, mode="csd", block=dim,
                             rng=rng)
    w_in = rng.uniform(-0.5, 0.5, (3, dim)).astype(np.float32)
    w_out = (rng.standard_normal((dim, 3)) / dim ** 0.5).astype(np.float32)
    op = SpecializedRollout(fm, w_in, mode="fp32", w_out=w_out, device=cuda)
    grid, _ = rollout_grid(op.tables, cuda, 2)
    assert grid.cw == cw and readout_path(cw) == "shared"
    u = torch.as_tensor(rng.uniform(-1, 1, (16, 4, 3)), dtype=torch.float32,
                        device=cuda)
    x0 = torch.zeros((4, dim), device=cuda)
    kw = dict(want_states=True, want_preds=True, want_final=False)
    (s, p), n, ro = _run(specialized_rollout, op, u, x0, 4, 1, n_blocks=2,
                         **kw)
    torch.cuda.synchronize()
    assert (n, ro) == (1, 1) and s.abs().max().item() > 0.1
    # each block's columns at the head of 1,024 (pad columns hold 0)
    xs = np.zeros((16, 4, 2048), np.float32)
    ws = np.zeros((2048, 3), np.float32)
    for k in range(2):
        xs[:, :, 1024 * k:1024 * k + cw] = s.cpu().numpy()[:, :, cw * k:
                                                            cw * (k + 1)]
        ws[1024 * k:1024 * k + cw] = w_out[cw * k:cw * (k + 1)]
    want = tree_readout(xs, ws, 1024)
    assert np.array_equal(p.cpu().numpy().view(np.uint32),
                          want.view(np.uint32))
    before = specialized_rollout.launches
    with pytest.raises(ValueError, match="at most 1024 columns"):
        _run(specialized_rollout, op, u, x0, 4, 1, n_blocks=1, **kw)
    assert specialized_rollout.launches == before


def test_ks_published_grid_and_io_counters(cuda):
    """At the published dim 9,000 the card plans 71 blocks of 128 columns,
    one an SM, their digit shares resident, the dense form with no tile;
    with ``obs`` on the grid's event says so, a launch adds
    :func:`io_macs` to ``rollout_io_macs_total`` (input and readout) and
    :func:`launch_counts`' digits, and B2 equals its plain twin bit for
    bit over T = 8, its predictions ``tree_readout`` over the twin's
    states bit for bit."""
    from test_torch_esn9000 import tree_readout
    from repro_torch import obs
    from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
        io_macs, launch_counts)
    op = _ks_op(cuda, 9000)
    u = torch.as_tensor(np.random.default_rng(9).uniform(-1, 1, (8, 2, 64)),
                        dtype=torch.float32, device=cuda)
    x0 = torch.zeros((2, 9000), device=cuda)
    kw = dict(want_states=True, want_preds=True, want_final=False)
    obs.configure()
    try:
        (s, p), _n, _ro = _run(specialized_rollout, op, u, x0, 2, 1, **kw)
        torch.cuda.synchronize()
        (ev,) = obs.events().events("rollout_grid")
        grid, _ = rollout_grid(op.tables, u.device)
        m = obs.metrics()
        macs = tuple(m.get("rollout_io_macs_total").value(
            kernel="specialized_rollout", part=part)
            for part in ("input", "readout"))
        digits = m.get("rollout_shiftadd_digits_total").value(
            kernel="specialized_rollout")
    finally:
        obs.disable()
    f = ev.fields
    assert (f["n_blocks"], f["cw"], f["resident"], f["form"], f["mm_terms"],
            f["blocks_per_sm"]) == (71, 128, True, "mma", 0, 1)
    assert f["digits"] == op.tables.n_digits > 60_000
    assert macs == io_macs(8, 2, 9000, 64, 64, 8) == (8 * 2 * 9000 * 64,) * 2
    assert digits == launch_counts(grid, 8, 2, 2)[1] == (
        8 * 2 * op.tables.n_digits)
    ps, pp = specialized_rollout_plain(
        u, op.tables, op.w_in, x0, op.w_out, leak=op.leak, smax=op.smax,
        recur_scale=op.recur_scale, **kw)
    assert torch.equal(s, ps)
    want = tree_readout(ps.cpu().numpy(), op.w_out.cpu().numpy(), grid.cw)
    assert np.array_equal(p.cpu().numpy().view(np.uint32),
                          want.view(np.uint32))
    assert (p - pp).abs().max().item() <= 1e-4


# -- fixed-matrix kernels (B3, B4, B5) against their twins on the card --------
def _fixed(dim_r, dim_c, sparsity, block, seed=0):
    rng = np.random.default_rng(seed)
    return FixedMatrix.compile(
        random_sparse_matrix(dim_r, dim_c, sparsity, rng) * 0.05,
        weight_bits=8, mode="csd", block=block, rng=rng)


@pytest.mark.parametrize("shape,block", [((256, 256), 64), ((200, 150), 64),
                                         ((1024, 1024), 128)])
@pytest.mark.parametrize("batch", [1, 3, 16, 20, 33])
@pytest.mark.parametrize("x_dtype", [torch.int8, torch.int32])
def test_bitplane_gemv_kernel_exact(cuda, shape, block, batch, x_dtype):
    fm = _fixed(*shape, 0.9, block)
    op = BitplaneGemv(fm, device=cuda)
    rng = np.random.default_rng(batch)
    x = torch.as_tensor(rng.integers(-128, 128, (batch, shape[0])),
                        dtype=x_dtype, device=cuda)
    before = bitplane_gemv.launches
    y = op(x)
    assert bitplane_gemv.launches == before + 1
    torch.cuda.synchronize()
    want = fm.matvec_int_exact(x)
    assert torch.equal(y, want)
    assert torch.equal(y, bitplane_gemv_plain(x, op.digits,
                                              op.plane_mask)[:, :shape[1]])


@pytest.mark.parametrize("shape,sparsity", [((256, 256), 0.95),
                                            ((256, 512), 0.999),
                                            ((200, 300), 0.9),
                                            ((1024, 1024), 0.95)])
@pytest.mark.parametrize("batch", [1, 5, 16, 33])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16,
                                     torch.int8, torch.int32])
def test_bcsr_matmul_kernel_matches_twin(cuda, shape, sparsity, batch,
                                         x_dtype):
    rng = np.random.default_rng(batch)
    d = random_sparse_matrix(*shape, sparsity, rng).astype(np.float32)
    if not x_dtype.is_floating_point:
        d = np.clip(np.round(d * 40), -128, 127).astype(np.float32)
    op = BcsrMatmul(BlockSparse.from_dense(d, 128), device=cuda)
    if x_dtype.is_floating_point:
        x = torch.as_tensor(rng.standard_normal((batch, shape[0])),
                            dtype=x_dtype, device=cuda)
    else:
        x = torch.as_tensor(rng.integers(-100, 100, (batch, shape[0])),
                            dtype=x_dtype, device=cuda)
    before = bcsr_matmul.launches
    y = op(x)
    assert bcsr_matmul.launches == before + 1
    want = bcsr_matmul_plain(x, op.tiles, op.col_ptr, op.tile_rows,
                             op.rows_pad)[:, :shape[1]]
    torch.cuda.synchronize()
    assert y.dtype == want.dtype
    if x_dtype.is_floating_point:
        assert (y - want).abs().max().item() <= 1e-4
    else:
        assert torch.equal(y, want)


@pytest.mark.parametrize("x_dtype", [torch.int8, torch.int32])
def test_bitplane_gemv_kernel_culled_planes(cuda, x_dtype):
    """A matrix whose high planes are all zero: only the kept planes are
    packed, and the product is exact; raw planes on the card (packed for
    the one call) give the same bits."""
    rng = np.random.default_rng(3)
    v = rng.integers(0, 4, size=(256, 192)).astype(np.float64)
    v[0, 0] = 127
    fm = FixedMatrix.compile(v, weight_bits=8, mode="csd", block=64, rng=rng)
    op = BitplaneGemv(fm, device=cuda)
    kept = sum(op.plane_mask)
    assert 0 < kept < len(op.plane_mask)
    assert op.packed.blob.numel() == kept * 256 * 192
    x = torch.as_tensor(rng.integers(-128, 128, (33, 256)), dtype=x_dtype,
                        device=cuda)
    y = op(x)
    raw = bitplane_gemv(x, op.digits, plane_mask=op.plane_mask)
    torch.cuda.synchronize()
    assert torch.equal(y, fm.matvec_int_exact(x))
    assert torch.equal(raw, y)


def test_bitplane_gemv_kernel_streams_a_large_share(cuda):
    """dim 4096: each block's 1 MiB share streams through a ring of
    stage buffers (int8 x, exact); an int32 x tile of that width does not
    fit one block and is refused."""
    fm = _fixed(4096, 4096, 0.99, 128)
    op = BitplaneGemv(fm, device=cuda)
    grid = op.packed.grid
    assert grid.buffers(True) < grid.n_stages
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.integers(-128, 128, (20, 4096)),
                        dtype=torch.int8, device=cuda)
    y = op(x)
    torch.cuda.synchronize()
    assert torch.equal(y, fm.matvec_int_exact(x))
    before = bitplane_gemv.launches
    with pytest.raises(ValueError, match="do not fit"):
        op(x.to(torch.int32))
    assert bitplane_gemv.launches == before


@pytest.mark.parametrize("batch", [1, 16])
def test_bcsr_matmul_fp32_is_deterministic(cuda, batch):
    """Every float sum has a fixed order: two calls give the same bits."""
    rng = np.random.default_rng(9)
    d = random_sparse_matrix(1024, 1024, 0.95, rng).astype(np.float32)
    op = BcsrMatmul(BlockSparse.from_dense(d, 128), device=cuda)
    x = torch.as_tensor(rng.standard_normal((batch, 1024)),
                        dtype=torch.float32, device=cuda)
    first = op(x)
    second = op(x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dim,batch", [(128, 1), (256, 3), (800, 16),
                                       (1024, 16), (1024, 20), (1024, 33),
                                       (1024, 1), (800, 1), (800, 33),
                                       (512, 5), (3104, 16), (3112, 16),
                                       (4096, 1)])
def test_reservoir_step_kernel_matches_twin(cuda, dim, batch):
    """Over the picker's grids: batch 20 and 33 take a second grid axis,
    dim 800 a ragged last column slice, dim 512 narrower slices (to keep
    a quarter of the SMs busy); at batch 16 dim 3104 is the last with
    128-column slices and 3112 the first with 64 (a share that fits one
    block's shared memory)."""
    rng = np.random.default_rng(dim + batch)
    w = (rng.standard_normal((dim, dim)) * (0.9 / np.sqrt(dim))
         ).astype(np.float32)
    w_in = rng.uniform(-0.5, 0.5, (2, dim)).astype(np.float32)
    fr = FusedReservoir(w, w_in, leak=0.3, device=cuda)
    u = torch.as_tensor(rng.standard_normal((12, batch, 2)),
                        dtype=torch.float32, device=cuda)
    before = reservoir_step.launches
    states = fr.run(u)
    assert reservoir_step.launches == before + 12
    x = torch.zeros((batch, dim), device=cuda)
    want = []
    for t in range(12):
        x = reservoir_step_plain(x, fr.w, u[t], fr.w_in, leak=0.3)
        want.append(x)
    torch.cuda.synchronize()
    assert (states - torch.stack(want)).abs().max().item() <= 1e-4


def _step_operands(dim, batch, seed, cuda):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=cuda)
    return (t(rng.uniform(-1, 1, (batch, dim))),
            t(rng.standard_normal((dim, dim)) * (0.9 / np.sqrt(dim))),
            t(rng.standard_normal((batch, 3))),
            t(rng.uniform(-0.5, 0.5, (3, dim))))


@pytest.mark.parametrize("dim,batch", [(1024, 16), (800, 1)])
def test_reservoir_step_raw_w_packs_per_call(cuda, dim, batch):
    """The functional entry with a raw dense CUDA W packs it for the one
    call and launches the kernel once."""
    x, w, u, w_in = _step_operands(dim, batch, 11, cuda)
    before = reservoir_step.launches
    got = reservoir_step(x, w, u, w_in, leak=0.4)
    assert reservoir_step.launches == before + 1
    want = reservoir_step_plain(x, w, u, w_in, leak=0.4)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("batch", [1, 16, 33])
def test_reservoir_step_is_deterministic(cuda, batch):
    """Every float sum has a fixed order: two launches give the same
    bits."""
    x, w, u, w_in = _step_operands(1024, batch, 12, cuda)
    fr = FusedReservoir(w, w_in, leak=0.5, device=cuda)
    first = fr.step(x, u)
    second = fr.step(x, u)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_reservoir_step_share_too_large_raises(cuda):
    """At dim 20480 a 16-row batch tile's share and x rows do not fit one
    block even in 8-column slices: the call raises, naming the shape, and
    launches nothing."""
    dim = 20480
    w = torch.empty((dim, dim), device=cuda)
    x = torch.zeros((16, dim), device=cuda)
    u, w_in = torch.zeros((16, 1), device=cuda), torch.zeros((1, dim),
                                                             device=cuda)
    before = reservoir_step.launches
    with pytest.raises(ValueError, match=r"\(20480, 20480\)"):
        reservoir_step(x, w, u, w_in)
    assert reservoir_step.launches == before


# -- the torch serve backend on the card --------------------------------------
def _esn(mode, cuda, dim=256, es=0.9, block=64, leak=0.7, input_dim=1):
    from repro_torch.core.esn import ESNConfig, init_esn
    cfg = ESNConfig(reservoir_dim=dim, element_sparsity=es, mode=mode,
                    leak=leak, seed=3, block=block, output_dim=2,
                    input_dim=input_dim)
    p = init_esn(cfg, device=cuda)
    gen = torch.Generator(device="cpu").manual_seed(4)
    w_out = (0.1 * torch.randn((dim, 2), generator=gen)).to(cuda)
    return dataclasses.replace(p, w_out=w_out)


_BACKEND_CASES = [("fp32", {}), ("fp32", {"dense_dispatch_density": 2.0}),
                  ("int8-csd", {}),
                  ("int8-csd", {"dense_dispatch_density": 2.0}),
                  ("int8-csd", {"specialize": False})]


@pytest.mark.parametrize("mode,kw", _BACKEND_CASES)
def test_torch_backend_matches_kernels_on_the_card(cuda, mode, kw):
    """The torch backend's states and predictions vs the cuda backend's
    (B2 / B1 launches) on the same card: within 1e-4 (the hoisted input
    projection and the readout sum in another order; int8 products are
    exact in both); chunked == one-shot bit for bit on both."""
    from repro_torch.serve import ReservoirEngine
    p = _esn(mode, cuda)
    t = ReservoirEngine(p, backend="torch", **kw)
    c = ReservoirEngine(p, backend="cuda", **kw)
    gen = torch.Generator(device="cpu").manual_seed(5)
    u = torch.randn((16, 24, 1), generator=gen).to(cuda)
    x0 = (0.3 * torch.randn((16, 256), generator=gen)).to(cuda)
    for want_states in (True, False):
        ts, tf = t.run_segment(u, x0, want_states=want_states)
        cs, cf = c.run_segment(u, x0, want_states=want_states)
        torch.cuda.synchronize()
        assert (ts - cs).abs().max().item() <= 1e-4
        assert (tf - cf).abs().max().item() <= 1e-4
    for eng in (t, c):
        one, xf = eng.run_segment(u, x0)
        carry = x0.clone()
        a, _ = eng.run_segment(u[:, :8], carry, donate_state=True)
        b, last = eng.run_segment(u[:, 8:], carry, donate_state=True)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat([a, b], dim=1), one)
        assert torch.equal(last, xf) and last.data_ptr() == carry.data_ptr()


@pytest.mark.parametrize("mode,kw", _BACKEND_CASES[2:])
def test_torch_backend_int8_products_exact_on_the_card(cuda, mode, kw):
    """The int8 schedules' products (float64 products of integers on the
    card) == matvec_int_exact and the integer ``xq @ q`` exactly."""
    from repro_torch.serve import ReservoirEngine
    p = _esn(mode, cuda)
    eng = ReservoirEngine(p, backend="torch", **kw)
    gen = torch.Generator(device="cpu").manual_seed(6)
    xq = torch.randint(-128, 128, (16, 256), generator=gen,
                       dtype=torch.int32).to(cuda)
    got = eng._int_product(xq)
    want = p.w.matvec_int_exact(xq)
    dense = p.w.matvec_int_dense_ref(xq.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got.cpu(), dense)


def test_torch_backend_keeps_fp32_under_tf32(cuda):
    """A caller that turns TF32 on does not change the fp32 backend's
    bits: its products run in IEEE fp32 regardless, and the caller's
    setting is back in place after the call."""
    from repro_torch.serve import ReservoirEngine
    p = _esn("fp32", cuda)
    eng = ReservoirEngine(p, backend="torch")
    gen = torch.Generator(device="cpu").manual_seed(7)
    u = torch.randn((16, 16, 1), generator=gen).to(cuda)
    x0 = torch.zeros((16, 256), device=cuda)
    mm = torch.backends.cuda.matmul
    old = mm.allow_tf32
    try:
        mm.allow_tf32 = False
        want, _ = eng.run_segment(u, x0)
        mm.allow_tf32 = True
        got, _ = eng.run_segment(u, x0)
        assert mm.allow_tf32 is True
    finally:
        mm.allow_tf32 = old
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_registry_swap_and_faults_on_the_card(cuda, backend):
    """Two models (B2's specialized and B1's generic) in one zero-copy
    pool on the card, a live publish and a transient fault: zero drops,
    versions pinned, every answer bit-exact against its pinned engine at
    the pool shape, and the retries recorded."""
    from repro_torch.runtime.faults import FaultEvent, FaultPlan
    from repro_torch.serve import (AsyncReservoirServer, ModelRegistry,
                                   SubmitSpec)
    reg = ModelRegistry(backend=backend)
    reg.register("a", _esn("int8-csd", cuda))
    reg.register("b", _esn("int8-csd", cuda, leak=0.5), specialize=False)
    plan = FaultPlan([FaultEvent("transient", at=1.0, count=2)])
    srv = AsyncReservoirServer(reg.engine("a"), n_slots=4, chunk_steps=8,
                               chunk_time=1.0, registry=reg, fault_plan=plan)
    assert srv.batcher.zero_copy
    rng = np.random.default_rng(8)
    inputs = [rng.standard_normal((int(n), 1)).astype(np.float32)
              for n in rng.integers(8, 40, 10)]
    handles = [srv.submit(SubmitSpec(u, model="ab"[i % 2], uid=i),
                          arrival_time=0.5 * i)
               for i, u in enumerate(inputs)]
    published = False
    while srv.step():
        if not published and srv.stats.completed >= 2:
            reg.publish("a", dataclasses.replace(
                reg.get("a").params, w_out=reg.get("a").params.w_out * 2))
            published = True
    assert published and len(srv.results) == len(inputs)
    assert srv.stats.retries == 2
    for i, q in enumerate(handles):
        eng = reg.engine(q.model, q.pinned_version)
        batch = torch.as_tensor(np.broadcast_to(
            inputs[i][None], (4,) + inputs[i].shape).copy(), device=cuda)
        want = eng.predictions(batch)[0].cpu().numpy()
        np.testing.assert_array_equal(srv.results[i].preds, want)
        assert srv.results[i].timings["version"] == q.pinned_version
    assert {q.pinned_version for q in handles if q.model == "a"} == {1, 2}


@pytest.mark.parametrize("mode", ["fp32", "int8-csd"])
def test_torch_backend_chunked_with_several_inputs(cuda, mode):
    """Three inputs: the hoisted (B*T, 3) x (3, R) projection changes shape
    with T, yet chunked states and predictions equal one-shot ones bit
    for bit on the card."""
    from repro_torch.serve import ReservoirEngine
    eng = ReservoirEngine(_esn(mode, cuda, input_dim=3), backend="torch")
    gen = torch.Generator(device="cpu").manual_seed(9)
    u = torch.randn((16, 40, 3), generator=gen).to(cuda)
    x0 = torch.zeros((16, 256), device=cuda)
    for want_states in (True, False):
        one, xf = eng.run_segment(u, x0, want_states=want_states)
        a, carry = eng.run_segment(u[:, :8], x0, want_states=want_states)
        b, last = eng.run_segment(u[:, 8:], carry, want_states=want_states)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat([a, b], dim=1), one)
        assert torch.equal(last, xf)


# -- the plan autotuner on the card -------------------------------------------
def test_cuda_hardware_fingerprint_format(cuda):
    from repro_torch.plan.autotune import hardware_fingerprint
    name = torch.cuda.get_device_name(0).replace(" ", "_")
    fp = hardware_fingerprint(cuda)
    assert fp == f"cuda:{name}x{torch.cuda.device_count()}"
    assert " " not in fp and hardware_fingerprint() == fp
    assert hardware_fingerprint("cpu") == "cpu:cpux1"


@pytest.mark.parametrize("mode", ["fp32", "int8-csd"])
def test_every_cuda_candidate_launches_at_batch_16(cuda, mode):
    """No cuda candidate has a batch tile above the kernel's 16 rows:
    every one builds and serves a batch of 16, one B2 launch per call."""
    from repro_torch.plan import candidate_schedules, plan_for
    from repro_torch.serve import ReservoirEngine
    p = _esn(mode, cuda, es=0.97, block=32)
    kmode = "fp32" if mode == "fp32" else "int8"
    cands = candidate_schedules(plan_for(p.w), kmode, ("cuda",))
    assert cands and max(c.batch_tile_max for c in cands) <= 16
    u = torch.zeros((16, 4, 1), device=cuda)
    for sched in cands:
        eng = ReservoirEngine(p, schedule=sched)
        before = specialized_rollout.launches
        eng.rollout(u)
        torch.cuda.synchronize()
        assert specialized_rollout.launches - before == 1


@pytest.mark.parametrize("mode", ["fp32", "int8-csd"])
def test_measured_autotune_on_the_card(cuda, mode):
    """A measured tuning over both backends on the card: the default is
    among the trials, the winner no worse than it, the cold pick's
    backend the winner's, and the winner's engine serves the default
    schedule's states (int8 bit for bit, fp32 within 1e-4)."""
    from repro_torch.plan import (ScheduleCache, autotune_rollout,
                                  default_schedule, plan_for,
                                  resolve_schedule)
    from repro_torch.serve import ReservoirEngine
    p = _esn(mode, cuda, es=0.97, block=32)
    plan = plan_for(p.w)
    kmode = "fp32" if mode == "fp32" else "int8"
    cold = resolve_schedule(plan, kmode, cache=ScheduleCache(), device=cuda)
    tuned = autotune_rollout(plan, kmode, params=p, top_k=3, reps=2,
                             cache=ScheduleCache(), device=cuda)
    default = default_schedule(plan, kmode)
    keys = [tuple(s.values()) for s, _p, _m in tuned.trials]
    assert default.key() in keys
    assert tuned.measured_s <= tuned.default_measured_s
    assert cold.schedule.backend == tuned.schedule.backend
    gen = torch.Generator(device="cpu").manual_seed(5)
    u = torch.randn((16, 32, 1), generator=gen).to(cuda)
    got = ReservoirEngine(p, schedule=tuned).rollout(u)
    want = ReservoirEngine(p, schedule=default).rollout(u)
    torch.cuda.synchronize()
    tol = 0.0 if kmode == "int8" else 1e-4
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("mode", ["fp32", "int8-csd"])
def test_auto_engine_serves_the_default_cuda_schedule(cuda, mode):
    """With a cold cache, ``"auto"`` on the card serves B2 at the default
    budget, crossover and tile: the card's prior decides the backend and
    the tile only, and a tie in tile goes to the default."""
    from repro_torch.plan import autotune_cache, default_schedule, plan_for
    from repro_torch.serve import ReservoirEngine
    p = _esn(mode, cuda, es=0.97, block=32)
    kmode = "fp32" if mode == "fp32" else "int8"
    autotune_cache().clear()
    eng = ReservoirEngine(p)
    want = default_schedule(plan_for(p.w), kmode, "cuda")
    assert eng.schedule.key() == want.key()
    assert (eng.backend, eng.vmem_budget, eng.crossover,
            eng.batch_tile_max) == want.key()[1:]


# -- sharded serving on the card (N shards on one card) -----------------------
def _card_mesh(cuda, n):
    """N shards: one per card when there are N cards, else N on one."""
    from repro_torch.launch.mesh import make_data_mesh
    cards = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(n)] if cards >= n
            else [cuda] * n)
    return make_data_mesh(devices=devs)


@pytest.mark.parametrize("batch", [16, 13])
@pytest.mark.parametrize("mode,kw", [("int8-csd", {}), ("fp32", {}),
                                     ("int8-csd", {"specialize": False})])
def test_sharded_engine_equals_single_on_the_card(cuda, mode, kw, batch):
    """(a) 4 shards (batch 13 pads to 16) against the single-device engine:
    states and fused-readout predictions bit for bit (the kernels compute
    every row alike whatever the batch), one launch per shard, the
    readout fused into it."""
    from repro_torch.dist import ShardedReservoirEngine
    from repro_torch.serve import ReservoirEngine
    p = _esn(mode, cuda)
    single = ReservoirEngine(p, backend="cuda", **kw)
    sharded = ShardedReservoirEngine(p, mesh=_card_mesh(cuda, 4),
                                     backend="cuda", **kw)
    fn = specialized_rollout if kw.get("specialize", True) \
        else reservoir_rollout
    gen = torch.Generator(device="cpu").manual_seed(batch)
    u = torch.randn((batch, 24, 1), generator=gen).to(cuda)
    x0 = (0.3 * torch.randn((batch, 256), generator=gen)).to(cuda)
    for want_states in (True, False):
        before = fn.launches, fn.fused_launches
        got, xf = sharded.run_segment(u, x0, want_states=want_states)
        fused = 0 if want_states else 4           # predictions: fused
        assert (fn.launches - before[0],
                fn.fused_launches - before[1]) == (4, fused)
        want, wxf = single.run_segment(u, x0, want_states=want_states)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(xf, wxf)


@pytest.mark.parametrize("zero_copy", [True, False])
def test_sharded_server_one_launch_per_live_shard_on_the_card(cuda,
                                                             zero_copy):
    """(b) 4 shards x 4 slots answer a burst bit for bit as the
    single-device 16-slot server; each chunk is one B2 launch per shard
    holding a live slot."""
    from repro_torch.dist import (DistributedReservoirServer,
                                  ShardedReservoirEngine)
    from repro_torch.serve import (AsyncReservoirServer, ReservoirEngine,
                                   SubmitSpec)
    p = _esn("int8-csd", cuda)
    mesh = _card_mesh(cuda, 4)
    srv = DistributedReservoirServer(
        ShardedReservoirEngine(p, mesh=mesh), slots_per_shard=4,
        chunk_steps=8, chunk_time=1.0, zero_copy=zero_copy,
        devices=list(mesh.devices))
    single = AsyncReservoirServer(ReservoirEngine(p), n_slots=16,
                                  chunk_steps=8, chunk_time=1.0,
                                  zero_copy=zero_copy)
    rng = np.random.default_rng(10)
    inputs = [rng.standard_normal((int(n), 1)).astype(np.float32)
              for n in rng.integers(4, 40, 24)]
    for s in (srv, single):
        for i, x in enumerate(inputs):
            s.submit(SubmitSpec(x, uid=i), arrival_time=0.0)
    expected, before = 0, specialized_rollout.launches
    while True:
        chunks = srv.stats.chunks
        if not srv.step():
            break
        if srv.stats.chunks > chunks:
            expected += len({srv.batcher.shard_of(s)
                             for s in srv.batcher.last_take})
    assert specialized_rollout.launches - before == expected
    want = single.run()
    for i in range(len(inputs)):
        np.testing.assert_array_equal(srv.results[i].preds, want[i].preds)


def test_sharded_shrink_grow_and_shard_death_on_the_card(cuda):
    """(c) A fault-plan shard death shrinks 4 -> 3, ``grow(1)`` restores
    4: zero drops, carried sequences, answers bit for bit as the
    undisturbed single-device server."""
    from repro_torch.dist import (DistributedReservoirServer,
                                  ShardedReservoirEngine)
    from repro_torch.runtime.faults import FaultEvent, FaultPlan
    from repro_torch.serve import (AsyncReservoirServer, ReservoirEngine,
                                   SubmitSpec)
    p = _esn("int8-csd", cuda)
    mesh = _card_mesh(cuda, 4)
    plan = FaultPlan([FaultEvent("shard_loss", at=2.0, shard=3)])
    srv = DistributedReservoirServer(
        ShardedReservoirEngine(p, mesh=mesh), slots_per_shard=4,
        chunk_steps=8, chunk_time=1.0, fault_plan=plan,
        devices=list(mesh.devices))
    single = AsyncReservoirServer(ReservoirEngine(p), n_slots=16,
                                  chunk_steps=8, chunk_time=1.0)
    rng = np.random.default_rng(11)
    inputs = [rng.standard_normal((int(n), 1)).astype(np.float32)
              for n in rng.integers(16, 64, 24)]
    for s in (srv, single):
        for i, x in enumerate(inputs):
            s.submit(SubmitSpec(x, uid=i), arrival_time=0.0)
    grown = None
    while srv.step():
        if grown is None and srv.reshards:
            assert srv.n_shards == 3
            grown = srv.grow(1)
    assert grown["n_shards_after"] == 4 and srv.n_shards == 4
    assert srv.readmitted > 0 and plan.injected == {"shard_loss": 1}
    assert srv.stats.completed == len(inputs) == len(srv.results)
    want = single.run()
    for i in range(len(inputs)):
        np.testing.assert_array_equal(srv.results[i].preds, want[i].preds)


# -- the LM serving path on the card ------------------------------------------
_LM_DENSE = ["gemma-2b", "internvl2-76b", "mistral-nemo-12b", "qwen3-32b",
             "stablelm-1.6b"]
# MoE and MLA (A12b), the recurrent blocks (A12c), the enc-dec stack (A12d)
_LM_LATER = ["deepseek-v2-236b", "olmoe-1b-7b", "recurrentgemma-2b",
             "whisper-base", "xlstm-350m"]
# the reference's own bound between two of its bf16 paths
# (tests/test_arch_smoke.py); float32 products in another order: 1e-4
_LM_BF16_TOL = 0.15


def _lm_pair(arch, dtype, cuda, **over):
    """A reduced config's LM and params on the CPU, and both on the card."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import LM
    cfg = reduced(get_config(arch)).replace(dtype=dtype, **over)
    lm = LM(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(1)).params
    return (cfg, lm, params, LM(cfg, device=cuda),
            tree_map(lambda a: a.to(cuda), params))


def _lm_batch(cfg, b, s, device, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (b, s)), device=device)}
    if cfg.frontend == "vision":
        batch["patches"] = torch.as_tensor(rng.standard_normal(
            (b, 4, cfg.d_model)).astype(np.float32), device=device)
    if cfg.encoder is not None:
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (b, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32),
            device=device)
    return batch


def _to(batch, device):
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("arch", _LM_DENSE + _LM_LATER)
def test_lm_fp32_on_card_matches_cpu(cuda, arch):
    """float32 prefill and four greedy decode steps on the card against
    the port on the CPU, with TF32 asked for by the caller (the LM keeps
    IEEE fp32): logits within 1e-4, tokens equal."""
    cfg, lm, params, glm, gparams = _lm_pair(arch, "float32", cuda)
    batch = _lm_batch(cfg, 2, 10, "cpu")
    mm = torch.backends.cuda.matmul
    old = mm.allow_tf32
    mm.allow_tf32 = True
    try:
        cl, cc = lm.prefill(params, batch, cache_len=16)
        gl, gc = glm.prefill(gparams, _to(batch, cuda), cache_len=16)
        for _ in range(4):
            assert (gl - cl.to(cuda)).abs().max().item() <= 1e-4
            tok = cl.argmax(-1)
            assert torch.equal(gl.argmax(-1).cpu(), tok)
            cl, cc = lm.decode_step(params, cc, tok)
            gl, gc = glm.decode_step(gparams, gc, tok.to(cuda))
        assert (gl - cl.to(cuda)).abs().max().item() <= 1e-4
    finally:
        mm.allow_tf32 = old
    assert mm.allow_tf32 == old


@pytest.mark.parametrize("arch", _LM_DENSE + _LM_LATER)
def test_lm_bf16_on_card_finite_and_argmax_agrees(cuda, arch):
    """bf16 on the card: finite logits within the bf16 bound of the CPU's,
    and the same argmax wherever the CPU's top-two margin exceeds twice
    the gap between the devices (a closer pair is a tie within noise)."""
    cfg, lm, params, glm, gparams = _lm_pair(arch, "bfloat16", cuda)
    batch = _lm_batch(cfg, 2, 12, "cpu", seed=1)
    cl, cc = lm.prefill(params, batch, cache_len=16)
    gl, gc = glm.prefill(gparams, _to(batch, cuda), cache_len=16)
    nxt = batch["tokens"][:, :1]
    cl2, _ = lm.decode_step(params, cc, nxt)
    gl2, _ = glm.decode_step(gparams, gc, nxt.to(cuda))
    for c, g in ((cl, gl), (cl2, gl2)):
        g = g.float().cpu()
        c = c.float()
        assert torch.isfinite(g).all()
        gap = (g - c).abs().max().item()
        assert gap <= _LM_BF16_TOL * (1 + c.abs().max().item())
        top2 = c.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * gap
        assert torch.equal(g.argmax(-1)[clear], c.argmax(-1)[clear])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_int8_on_card_matches_cpu(cuda, dtype):
    """quantize_tree on the card == on the CPU (q and scale exactly), and
    int8 serving on the card against the CPU's int8 serving."""
    from repro_torch.models.quantize import quantize_tree
    cfg, lm, params, glm, gparams = _lm_pair(
        "mistral-nemo-12b", dtype, cuda, n_layers=2, d_model=1024,
        n_heads=8, n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=1024)
    cq, gq = quantize_tree(params), quantize_tree(gparams)
    for name in ("embed", "lm_head"):
        assert torch.equal(gq[name]["q"].cpu(), cq[name]["q"])
        assert torch.equal(gq[name]["scale"].cpu(), cq[name]["scale"])
    w = "w_up"
    assert torch.equal(gq["groups"]["b0"]["mlp"][w]["q"].cpu(),
                       cq["groups"]["b0"]["mlp"][w]["q"])
    batch = _lm_batch(cfg, 2, 8, "cpu", seed=2)
    cl, cc = lm.prefill(cq, batch, cache_len=10)
    gl, gc = glm.prefill(gq, _to(batch, cuda), cache_len=10)
    nxt = batch["tokens"][:, :1]
    cl2, _ = lm.decode_step(cq, cc, nxt)
    gl2, _ = glm.decode_step(gq, gc, nxt.to(cuda))
    tol = 1e-4 if dtype == "float32" else _LM_BF16_TOL
    for c, g in ((cl, gl), (cl2, gl2)):
        assert torch.isfinite(g.float()).all()
        assert (g.float().cpu() - c.float()).abs().max().item() <= \
            tol * (1 + c.float().abs().max().item())


@pytest.mark.parametrize("quantized", [False, True])
def test_lm_decode_step_never_syncs(cuda, quantized):
    """A decode step (and its greedy argmax) queues its work without one
    host-device synchronisation: the position is a device tensor."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.quantize import quantize_tree
    over = dict(n_layers=2, d_model=1024, n_heads=8, n_kv_heads=2,
                head_dim=64, d_ff=512, vocab_size=1024) if quantized else {}
    cfg, _, _, glm, gparams = _lm_pair("mistral-nemo-12b", "bfloat16",
                                       cuda, **over)
    if quantized:
        gparams = quantize_tree(gparams)
    prefill = make_prefill_step(glm, None, 12)
    decode = make_decode_step(glm, None)
    logits, caches = prefill(gparams, _lm_batch(cfg, 2, 8, cuda))
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            logits, caches = decode(gparams, caches, tok)
            tok = logits.argmax(-1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(caches["index"]) == 11


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_moe_decode_step_never_syncs(cuda, arch):
    """A MoE decode step (routing, the sort-based dispatch, MLA's latent
    cache for deepseek) queues its work without a host-device
    synchronisation: every shape is static."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    cfg, _, _, glm, gparams = _lm_pair(arch, "bfloat16", cuda)
    logits, caches = make_prefill_step(glm, None, 12)(
        gparams, _lm_batch(cfg, 4, 8, cuda))
    decode = make_decode_step(glm, None)
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            logits, caches = decode(gparams, caches, tok)
            tok = logits.argmax(-1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(caches["index"]) == 11


def _moe_at_capacity(arch):
    """The reduced config's MoE at the full config's capacity factor
    (1.25), so a decode step of batch 4 drops assignments too."""
    from repro_torch.configs import get_config, reduced
    m = reduced(get_config(arch)).moe
    return m.__class__(n_experts=m.n_experts, top_k=m.top_k,
                       d_expert=m.d_expert, n_shared=m.n_shared)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_moe_decode_repeats_bit_for_bit(cuda, arch):
    """Two decode steps from the same caches give the same logits and
    caches bit for bit: the combine sums each token's k contributions in
    a fixed order, with no atomic adds."""
    from repro_torch.models.common import tree_map
    cfg, _, _, glm, gparams = _lm_pair(arch, "float32", cuda,
                                       moe=_moe_at_capacity(arch))
    logits, caches = glm.prefill(gparams, _lm_batch(cfg, 4, 8, cuda),
                                 cache_len=12)
    tok = logits.argmax(-1)
    outs = []
    for _ in range(2):
        mine = tree_map(lambda a: a.clone(), caches)
        lg, mine = glm.decode_step(gparams, mine, tok)
        outs.append((lg, mine))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1]["groups"]["b0"]["pos"],
                       outs[1][1]["groups"]["b0"]["pos"])


# -- training (A12e) -----------------------------------------------------------
# a train step on the card against the CPU's, float32: the loss within
# 1e-5 (as the CPU parity tests hold it), moments within 1e-4 of each
# leaf's max (gradients summed in another order), parameters within the
# first AdamW step's sensitivity to that (see _first_step_tol)
_TRAIN_OPT = dict(lr=1e-2, warmup_steps=0, total_steps=10)


def _first_step_tol(g, lr, rel=1e-4, eps=1e-8):
    """How far two first AdamW steps may land apart when their gradients
    ``g`` agree within ``rel * max|g|``: ``lr g / (|g| + eps)`` moves by at
    most ``2 lr min(1, eps dg / g^2)``, plus 1e-6 of rounding."""
    g = g.abs()
    dg = rel * g.max()
    return 1e-6 + 2 * lr * torch.clamp(eps * dg / g.square(), max=1.0)


def _train_flat(tree):
    from repro_torch.models.common import tree_leaves_with_path
    return {"/".join(map(str, p)): x for p, x in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "olmoe-1b-7b",
                                  "xlstm-350m"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import tree_map
    from repro_torch.optim import adamw
    cfg, lm, params, glm, _ = _lm_pair(arch, "float32", cuda)
    # a copy: each step writes its own state in place
    gparams = tree_map(lambda a: a.to(cuda, copy=True), params)
    batch = _lm_batch(cfg, 4, 17, "cpu", seed=3)
    opt = adamw.AdamWConfig(**_TRAIN_OPT)
    state = {"params": params, "opt": adamw.init_state(params)}
    gstate = {"params": gparams, "opt": adamw.init_state(gparams)}
    mm = torch.backends.cuda.matmul
    old = mm.allow_tf32
    mm.allow_tf32 = True                 # the step keeps IEEE fp32
    try:
        _, m = make_train_step(lm, None, opt)(state, batch)
        _, gm = make_train_step(glm, None, opt)(gstate, _to(batch, cuda))
    finally:
        mm.allow_tf32 = old
    assert abs(float(gm["loss"]) - float(m["loss"])) <= 1e-5
    assert float(gm["grad_norm"]) == pytest.approx(float(m["grad_norm"]),
                                                   rel=1e-4)
    want, got = _train_flat(state), _train_flat(gstate)
    assert int(got["opt/step"]) == 1
    for name, x in got.items():
        w, x = want[name], x.cpu()
        if name.startswith(("opt/m", "opt/v")):
            assert (x - w).abs().max() <= 1e-4 * w.abs().max(), name
        elif name.startswith("params"):
            g = want["opt/m" + name[len("params"):]] / 0.1
            assert ((x - w).abs() <= _first_step_tol(
                g, _TRAIN_OPT["lr"])).all(), name


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "olmoe-1b-7b",
                                  "xlstm-350m"])
def test_remat_modes_equal_on_card(cuda, arch):
    """none, dots and full: the same loss and gradients bit for bit on
    the card, bf16."""
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.transformer import LM
    cfg, _, _, _, gparams = _lm_pair(arch, "bfloat16", cuda)
    batch = _lm_batch(cfg, 2, 17, cuda, seed=4)
    runs = []
    for mode in ("none", "dots", "full"):
        lm = LM(cfg.replace(remat=mode), device=cuda)
        req = tree_map(lambda p: p.detach().requires_grad_(), gparams)
        loss = lm.loss(req, batch)
        runs.append((loss.detach(), torch.autograd.grad(
            loss, tree_leaves(req))))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1]))


def test_checkpoint_restore_on_card(cuda, tmp_path):
    """A train state on the card (bf16 parameters, float32 moments, an
    int32 step) saved and restored onto the card bit for bit."""
    from repro_torch.checkpoint import store
    from repro_torch.models.common import tree_map
    from repro_torch.optim import adamw
    _, _, _, _, gparams = _lm_pair("stablelm-1.6b", "bfloat16", cuda)
    state = {"params": gparams, "opt": adamw.init_state(gparams)}
    state["opt"]["m"] = tree_map(
        lambda a: torch.randn_like(a, dtype=torch.float32), gparams)
    ck = store.Checkpointer(tmp_path, every=1, keep=1)
    ck.maybe_save(state, 3)
    ck.finalize()
    assert store.latest_step(tmp_path) == 3
    out = store.restore(tree_map(torch.empty_like, state), tmp_path, 3)
    for (name, a), b in zip(_train_flat(state).items(),
                            _train_flat(out).values()):
        assert b.device == a.device and b.dtype == a.dtype, name
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), name


def test_cuda_mesh_refuses_gloo(cuda, tmp_path):
    """No entry point of the port builds a CUDA device mesh over gloo (the
    mesh whose ranks die in DTensor's first redistribute on a card,
    ROADMAP C-port-9): ``make_mesh`` refuses it before DTensor sees it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        with pytest.raises(RuntimeError, match="a CUDA mesh runs on NCCL"):
            make_mesh((1, 1), ("data", "model"), "cuda")
    finally:
        dist.destroy_process_group()
