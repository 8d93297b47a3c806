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
* The CUDA kernel's host side: each thread block's packed share (column
  slice, bytes, digits) against a direct computation from the tables, the
  shares decoded by the m16n8k32 fragment layout give the exact recurrent
  product, and the grid and residency choice at LARGE_1024.
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
    build_tables, check_operands, pack_blocks, plain_recurrent_product,
    plan_grid, reservoir_rollout, rollout_readout, smem_bytes)
from repro_torch.kernels.reservoir_rollout.specialized import (
    SpecializedRollout, specialized_rollout)
from repro_torch.plan import plan_for
from repro_torch.plan.specialize import MM, SA

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
    check_operands(u, op.tables, w_in, x0, None, None, 16, False, 1)
    with pytest.raises(ValueError, match="thread block"):
        check_operands(u, op.tables, w_in, x0, None, None, 17, False, 1)


# -- the CUDA kernel's host side: per-block shares and the grid ---------------
_LANE = np.arange(32)
_GID, _TIG = _LANE >> 2, _LANE & 3


def _decode_shares(tables, shares, x):
    """The kernel's reads of the packed shares, in numpy: each block's MM
    tiles decoded by the m16n8k32 B-fragment layout (lane l holds rows
    4 (l % 4) + e and 16 + 4 (l % 4) + e of column l // 4) or as fp32
    (term, row, column) floats, its digits from their uint32 words; the
    recurrent product of the (B, rows_pad) state ``x`` over all blocks."""
    bk, cw = tables.block, shares.cw
    groups, kch = cw // 8, bk // 32
    exact = tables.int8
    x = x.astype(np.int64 if exact else np.float64)
    out = np.zeros((x.shape[0], tables.rows_pad), x.dtype)
    k_idx = (np.arange(2)[None, :, None] * 16 + _TIG[:, None, None] * 4
             + np.arange(4)[None, None, :])
    n_idx = np.broadcast_to(_GID[:, None, None], k_idx.shape)
    for blk in range(shares.n_blocks):
        ci, sl = divmod(blk, shares.slices)
        c0 = ci * bk + sl * cw
        off, n_mm, n_digits, n_bytes = shares.meta[blk]
        share = shares.blob[off:off + n_bytes]
        terms = share[:8 * n_mm].view(np.int32).reshape(-1, 2)
        head = -(-8 * n_mm // 16) * 16
        tile_bytes = n_mm * bk * cw * (1 if exact else 4)
        for m, (rb, shift) in enumerate(terms):
            if exact:
                w = np.zeros((bk, cw), np.int64)
                for kc in range(kch):
                    for g in range(groups):
                        at = head + ((m * kch + kc) * groups + g) * 256
                        frag = share[at:at + 256].view(np.int8).reshape(
                            32, 2, 4)
                        w[kc * 32 + k_idx, g * 8 + n_idx] = frag
            else:
                at = head + m * bk * cw * 4
                w = share[at:at + bk * cw * 4].view(np.float32).reshape(
                    bk, cw).astype(np.float64)
            prod = x[:, rb * bk:(rb + 1) * bk] @ w
            out[:, c0:c0 + cw] += prod << shift if exact else prod
        at = head + tile_bytes
        words = share[at:at + 4 * n_digits].view(np.uint32)
        for word in words.astype(np.int64):
            v = x[:, word & 0xFFFF] << ((word >> 24) & 0xF)
            out[:, c0 + ((word >> 16) & 0xFF)] += -v if word >> 28 else v
    return out


def _expected_share(tables, ci, c0, cw):
    """(MM terms, digits, share bytes) of the block owning columns
    c0 .. c0 + cw of column block ci, counted from the term tables
    directly: 8 bytes per term (padded to 16), its tile slices, 4 bytes
    per digit, padded to 16."""
    cp = tables.col_ptr_host
    n_mm = n_dg = 0
    for kind, _a, lo, hi in tables.terms_host[cp[ci]:cp[ci + 1]]:
        if kind == 0:
            n_mm += 1
        else:
            j = tables.digits_host[lo:hi, 1]
            n_dg += int(((j >= c0) & (j < c0 + cw)).sum())
    elt = 1 if tables.int8 else 4
    head = -(-8 * n_mm // 16) * 16
    body = head + n_mm * tables.block * cw * elt + 4 * n_dg
    return n_mm, n_dg, -(-body // 16) * 16


def _check_shares(tables, x, slice_options):
    want = plain_recurrent_product(torch.as_tensor(x), tables).numpy()
    ncb, bk = tables.n_col_blocks, tables.block
    for slices in slice_options:
        shares = pack_blocks(tables, ncb * slices)
        assert shares.cw == bk // slices
        offsets = np.cumsum([0] + list(shares.meta[:, 3]))
        assert (shares.meta[:, 0] == offsets[:-1]).all()
        assert (shares.meta[:, 0] % 16 == 0).all()
        for blk in range(ncb * slices):
            ci, sl = divmod(blk, slices)
            assert tuple(shares.meta[blk, 1:]) == _expected_share(
                tables, ci, sl * shares.cw, shares.cw)
        got = _decode_shares(tables, shares, x)
        if tables.int8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="8-column groups"):
        pack_blocks(tables, ncb * 3)


@pytest.mark.parametrize("kernel", ["generic", "specialized"])
@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("mode", MODES)
def test_block_shares_decode_to_recurrent_product(mode, regime, kernel):
    """Every grid size's shares: column slices and bytes from the tables,
    and, decoded as the kernel reads them, the exact int32 product (int8)
    or the fp32 product within 1e-5 of the twin's."""
    _j, _js, t_gen, t_spec = _pair(mode, regime)
    tables = (t_gen if kernel == "generic" else t_spec).tables
    rng = np.random.default_rng(5)
    if tables.int8:
        x = rng.integers(-128, 128, (3, DIM)).astype(np.int32)
    else:
        x = rng.standard_normal((3, DIM)).astype(np.float32)
    _check_shares(tables, x, (1, 2, 4, 8))          # 8 columns at 8


def test_block_shares_carry_shift_add_digits():
    """A sparse plan (97 % zeros, block 32) whose thin digit planes become
    shift-add terms: each block keeps exactly the digits of its columns,
    and the decoded shares give the exact product."""
    rng = np.random.default_rng(0)
    fm = FixedMatrix.compile(random_sparse_matrix(DIM, DIM, 0.97, rng) * 0.05,
                             weight_bits=8, mode="csd", block=32, rng=rng)
    op = SpecializedRollout(fm, np.zeros((1, DIM), np.float32), mode="int8",
                            device="cpu")
    assert op.tables.n_digits > 0 and op.tables.n_matmul_terms > 0
    x = rng.integers(-128, 128, (5, DIM)).astype(np.int32)
    _check_shares(op.tables, x, (1, 2, 4))


@pytest.mark.parametrize("with_digits", [True, False])
def test_block_shares_limit_digit_slices_to_256_columns(with_digits):
    """A digit word holds its column within the slice in 8 bits: block 512
    with shift-add digits packs into slices of 256 columns or fewer (the
    digit at column 300 lands at 44 of the second slice) and refuses one
    slice of 512; without digits one slice of 512 packs."""
    rng = np.random.default_rng(1)
    bk = 512
    data = rng.integers(-3, 4, (1, 1, bk, bk)).astype(np.int8)
    terms = ((MM, 0, 1, 0),)
    if with_digits:
        terms += ((SA, 0, ((3, 300, -1, 2), (7, 10, 1, 0))),)
    tables = build_tables((((0, terms),),), data, mode="int8",
                          n_col_blocks=1, device="cpu")
    assert tables.n_digits == (2 if with_digits else 0)
    x = rng.integers(-128, 128, (3, bk)).astype(np.int32)
    _check_shares(tables, x, (2, 4))
    if with_digits:
        assert pack_blocks(tables, 2).meta[1, 2] == 1
        with pytest.raises(ValueError, match="at most 256 columns"):
            pack_blocks(tables, 1)
    else:
        _check_shares(tables, x, (1,))


def test_twin_operands_made_only_when_the_twin_runs():
    """The kernel reads only its packed shares: building the tables and
    packing them put no tiles or digits on the device; the twin's first
    run does, once."""
    rng = np.random.default_rng(0)
    fm = FixedMatrix.compile(random_sparse_matrix(DIM, DIM, 0.97, rng) * 0.05,
                             weight_bits=8, mode="csd", block=32, rng=rng)
    op = SpecializedRollout(fm, np.zeros((1, DIM), np.float32), mode="int8",
                            device="cpu")
    pack_blocks(op.tables, op.tables.n_col_blocks)
    assert op.tables._twin_operands == {}
    op(torch.zeros((2, 3, 1)))
    tiles, digits = op.tables.tiles, op.tables.digits
    assert set(op.tables._twin_operands) == {"tiles", "digits"}
    assert tiles.dtype == torch.int8 and digits.shape == (
        op.tables.n_digits, 4)
    op(torch.zeros((2, 3, 1)))
    assert op.tables.tiles is tiles and op.tables.digits is digits


@pytest.fixture(scope="module")
def large_1024():
    """LARGE_1024's B2 (specialized) and B1 (generic) int8 tables and its
    fp32 B1 tables, built on the CPU."""
    from repro_torch.configs.esn_paper import LARGE_1024
    from repro_torch.core.esn import init_esn
    params = init_esn(LARGE_1024, device="cpu")
    plan = params.w.plan()
    return (SpecializedRollout(plan, params.w_in, mode="int8",
                               device="cpu").tables,
            FusedRollout(plan, params.w_in, mode="int8",
                         device="cpu").tables,
            FusedRollout(plan, params.w_in, mode="fp32",
                         device="cpu").tables)


def _one_per_sm(smem):
    """A 132-SM card holding one block per SM at up to 227 KiB."""
    return 132 if smem <= 227 * 1024 else 0


@pytest.mark.parametrize("n_blocks,b2_share,b1_share,b1_resident", [
    (128, 8 * 1024, 64 * 1024, True),
    (64, 16 * 1024, 128 * 1024, True),
    (32, 32 * 1024, 256 * 1024, False)])
def test_large_1024_grid_and_residency(large_1024, n_blocks, b2_share,
                                       b1_share, b1_resident):
    """At LARGE_1024 (8 column blocks of 128, 64 folded tiles for B2, 512
    plane tiles for B1, no digits) a block of 8 columns holds 8 KiB of
    B2's tiles and 64 KiB of B1's, beside 8 bytes per term (8 and 64
    terms); at 32 blocks B1's 256 KiB does not fit and streams.  Shared
    memory: the mbarrier, 16 rows of the int8 state (1024 + 16 bytes
    each), three 16 x cw arrays of 4-byte values (the int32 accumulator,
    u . W_in and x(n-1)), and the share when resident."""
    b2, b1, _f32 = large_1024
    assert (b2.n_matmul_terms, b2.n_digits, b1.n_matmul_terms) == (64, 0, 512)
    for tables, tiles, n_mm, resident in (
            (b2, b2_share, 8, True), (b1, b1_share, 64, b1_resident)):
        grid = plan_grid(tables, _one_per_sm, n_blocks)
        cw = 1024 // n_blocks
        base = 16 + 16 * 1040 + 16 * cw * 12
        share = 8 * n_mm + tiles
        assert (grid.n_blocks, grid.slices, grid.cw) == (n_blocks,
                                                         n_blocks // 8, cw)
        assert grid.share_bytes == share
        assert (grid.shares.meta[:, 1:] == (n_mm, 0, share)).all()
        assert grid.resident is resident
        assert grid.smem == base + (share if resident else 0)
        assert smem_bytes(tables, cw, share) == base + share


def test_large_1024_default_grid(large_1024):
    """The default grid is the narrowest slicing the card holds at once:
    128 blocks of 8 columns on 132 SMs, whatever the tables' share; with
    room for only 100 blocks it falls to 64.  fp32 stages 16 rows of
    4 x 1024 + 16 bytes and keeps B1's 32 KiB of tiles (8 terms)
    resident."""
    b2, b1, f32 = large_1024
    for tables in (b2, b1, f32):
        assert plan_grid(tables, _one_per_sm).n_blocks == 128
        assert plan_grid(tables, lambda smem: 100).n_blocks == 64
    grid = plan_grid(f32, _one_per_sm)
    assert (grid.share_bytes, grid.resident) == (64 + 32 * 1024, True)
    assert grid.smem == 16 + 16 * (4 * 1024 + 16) + 16 * 8 * 8 + 64 + \
        32 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        plan_grid(f32, lambda smem: 0)
