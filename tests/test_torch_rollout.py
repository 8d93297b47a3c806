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
  shares decoded by the m16n8k32 fragment layout, or as the list form's
  (row, weight) words, give the exact recurrent product, the form the
  rule chooses, and the grid and residency choice at LARGE_1024.  The
  port's ops take no band budget: the shares of a program lowered at any
  budget are byte-identical to the unbanded one's.
"""

import math

import jax
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
from repro_torch.kernels.reservoir_rollout import reservoir_rollout as rr
from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
from repro_torch.kernels.reservoir_rollout.ref import (rollout_fp32_ref,
                                                       rollout_int8_ref)
from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
    build_tables, check_operands, generic_schedules, pack_blocks,
    plain_recurrent_product, plan_grid, reservoir_rollout, smem_bytes)
from repro_torch.kernels.reservoir_rollout.specialized import (
    SpecializedRollout, specialized_rollout)
from repro_torch.plan import DEFAULT_VMEM_BUDGET, plan_for, specialize_rollout
from repro_torch.plan.specialize import MM, SA


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


DIM, BLOCK = 256, 64
TILE = BLOCK * BLOCK
PIPELINE_BUDGET = {"fp32": TILE * 4 * 10, "int8": TILE * 10}
MODES = ("fp32", "int8-pn", "int8-csd")
REGIMES = ("resident", "pipelined")
TOL = 1e-5

_PAIRS = {}
_PORT = {}


def _pair(esn_mode, regime):
    """(reference generic, reference specialized, port generic, port
    specialized) rollout ops for one mode/regime, on identical weights.
    The port's ops take no budget: one pair serves both regimes."""
    key = (esn_mode, regime)
    if key not in _PAIRS:
        digit = "pn" if esn_mode == "int8-pn" else "csd"
        kmode = "fp32" if esn_mode == "fp32" else "int8"
        budget = None if regime == "resident" else PIPELINE_BUDGET[kmode]
        rng = np.random.default_rng(0)
        jfm = JFixedMatrix.compile(j_random_sparse(DIM, DIM, 0.9, rng) * 0.05,
                                   weight_bits=8, mode=digit, block=BLOCK,
                                   rng=rng)
        rng = np.random.default_rng(7)
        w_in = rng.uniform(-0.5, 0.5, (4, DIM)).astype(np.float32)
        w_out = rng.uniform(-0.1, 0.1, (DIM, 4)).astype(np.float32)
        kw = dict(leak=0.7, mode=kmode, w_out=w_out)
        if esn_mode not in _PORT:
            rng = np.random.default_rng(0)
            tfm = FixedMatrix.compile(random_sparse_matrix(DIM, DIM, 0.9, rng)
                                      * 0.05, weight_bits=8, mode=digit,
                                      block=BLOCK, rng=rng)
            _PORT[esn_mode] = (
                FusedRollout(plan_for(tfm), w_in, device="cpu", **kw),
                SpecializedRollout(plan_for(tfm), w_in, batch_tile_max=8,
                                   device="cpu", **kw))
        ops = (JFused(j_plan_for(jfm), w_in, **kw),
               JSpecialized(j_plan_for(jfm), w_in, vmem_budget=budget,
                            batch_tile_max=8, **kw),
               *_PORT[esn_mode])
        assert ops[1].regime == regime
        assert ops[3].program.vmem_budget is None
        assert ops[2].layout.vmem_budget is None
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
    counters = lambda: tuple(                                # noqa: E731
        (fn.launches, fn.fused_launches)
        for fn in (reservoir_rollout, specialized_rollout))
    before = counters()
    t_gen(torch.as_tensor(_inputs(batch=2, t=2)), want_preds=True)
    t_spec(torch.as_tensor(_inputs(batch=2, t=2)), want_preds=True)
    assert counters() == before
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


_FOLDED = {}


def _folded(tables):
    """The int8 table's folded weights as a dense (rows_pad, rows_pad)
    int64 matrix, straight from the term tables: each MM term's tile
    << shift at (row block, column block), each digit's +-(1 << w)."""
    if id(tables) in _FOLDED and _FOLDED[id(tables)][0] is tables:
        return _FOLDED[id(tables)][1]
    bk = tables.block
    q = np.zeros((tables.rows_pad, tables.rows_pad), np.int64)
    cp = tables.col_ptr_host
    for ci in range(tables.n_col_blocks):
        cols = slice(ci * bk, (ci + 1) * bk)
        for kind, a, c, d in tables.terms_host[cp[ci]:cp[ci + 1]]:
            if kind == 0:
                q[d * bk:(d + 1) * bk, cols] += (
                    tables.data_host[a].astype(np.int64) << c)
            else:
                dg = tables.digits_host[c:d].astype(np.int64)
                np.add.at(q, (a * bk + dg[:, 0], ci * bk + dg[:, 1]),
                          dg[:, 2] << dg[:, 3])
    _FOLDED[id(tables)] = (tables, q)
    return q


def _lanes(cw):
    """Lanes per column of the list form: 256 // cw rounded down to a
    power of two, at least 1."""
    lanes = 1
    while 2 * lanes * cw <= 256:
        lanes *= 2
    return lanes


def _decode_lists(tables, shares, x):
    """The list form as the kernel reads it: block k's word (i, j, l) at
    ((i cw + j) lanes + l) is entry i lanes + l of column j, row in bits
    0-15 and the signed weight in bits 16-31.  Asserts each column's
    entries are its nonzero folded weights, once each, in ascending rows
    and then zero padding; returns the product of ``x``."""
    bk, cw = tables.block, shares.cw
    lanes = _lanes(cw)
    q = _folded(tables)
    x = x.astype(np.int64)
    out = np.zeros((x.shape[0], tables.rows_pad), np.int64)
    for blk in range(shares.n_blocks):
        ci, sl = divmod(blk, shares.slices)
        c0 = ci * bk + sl * cw
        off, per_lane, n_digits, n_bytes = shares.meta[blk]
        assert n_digits == 0 and n_bytes == per_lane * cw * lanes * 4
        words = shares.blob[off:off + n_bytes].view(np.uint32).reshape(
            per_lane, cw, lanes)
        rows = (words & 0xFFFF).astype(np.int64)
        wts = (words.view(np.int32) >> 16).astype(np.int64)
        for j in range(cw):
            r = rows[:, j, :].reshape(-1)          # entry order i lanes + l
            w = wts[:, j, :].reshape(-1)
            n = int((w != 0).sum())
            assert (w[n:] == 0).all() and (r[n:] == 0).all()
            assert (np.diff(r[:n]) > 0).all()
            col = q[:, c0 + j]
            np.testing.assert_array_equal(r[:n], np.flatnonzero(col))
            np.testing.assert_array_equal(w[:n], col[r[:n]])
        out[:, c0:c0 + cw] = np.einsum("bicl,icl->bc", x[:, rows], wts)
    return out


def _decode_shares(tables, shares, x):
    """The kernel's reads of the packed shares, in numpy: each block's MM
    tiles decoded by the m16n8k32 B-fragment layout (lane l holds rows
    4 (l % 4) + e and 16 + 4 (l % 4) + e of column l // 4) or as fp32
    (term, 8-column group, row, column) floats, its digits from their
    uint32 words, or the list form (:func:`_decode_lists`); the
    recurrent product of the (B, rows_pad) state ``x`` over all blocks."""
    if shares.form == "lists":
        return _decode_lists(tables, shares, x)
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
                    groups, bk, 8).transpose(1, 0, 2).reshape(
                        bk, cw).astype(np.float64)
            prod = x[:, rb * bk:(rb + 1) * bk] @ w
            out[:, c0:c0 + cw] += prod << shift if exact else prod
        at = head + tile_bytes
        words = share[at:at + 4 * n_digits].view(np.uint32)
        for word in words.astype(np.int64):
            v = x[:, word & 0xFFFF] << ((word >> 24) & 0xF)
            out[:, c0 + ((word >> 16) & 0xFF)] += -v if word >> 28 else v
    return out


def _replay_f32_lanes(tables, shares, x):
    """The fp32 product as the kernel's lanes read it, in float64: in each
    block, warp unit (group g, range w) of ``max(1, 8 / groups)`` ranges
    per group, lane (column j8, kq) reads rows q = w * span + kq, + 4, ...
    of the flattened q = term * bk + row, its state word at (mm[m].x - m) *
    bk + q and its tile word at (m (groups - 1) + g) bk 8 + 8 q + j8.
    Asserts every output reads each row of its terms, and each tile word
    of its column, exactly once; returns the (B, rows_pad) product."""
    bk, cw = tables.block, shares.cw
    groups = cw // 8
    wpg = max(1, 8 // groups)
    x = x.astype(np.float64)
    out = np.zeros((x.shape[0], tables.rows_pad))
    j8 = np.arange(8)
    for blk in range(shares.n_blocks):
        ci, sl = divmod(blk, shares.slices)
        c0 = ci * bk + sl * cw
        off, n_mm, _n_digits, n_bytes = shares.meta[blk]
        share = shares.blob[off:off + n_bytes]
        mm = share[:8 * n_mm].view(np.int32).reshape(-1, 2)
        head = -(-8 * n_mm // 16) * 16
        tiles = share[head:head + n_mm * bk * cw * 4].view(
            np.float32).astype(np.float64)
        span = n_mm * bk // wpg
        assert span % 4 == 0
        rows = np.sort((mm[:, :1] * bk + np.arange(bk)).reshape(-1))
        for g in range(groups):
            read_x, read_w = [], []
            for w in range(wpg):
                for kq in range(4):
                    q = np.arange(w * span + kq, (w + 1) * span, 4)
                    m = q // bk
                    xi = (mm[m, 0] - m) * bk + q
                    wi = (m * (groups - 1) + g) * bk * 8 + 8 * q
                    out[:, c0 + g * 8:c0 + g * 8 + 8] += (
                        x[:, xi] @ tiles[wi[:, None] + j8])
                    read_x.append(xi)
                    read_w.append(wi)
            np.testing.assert_array_equal(np.sort(np.concatenate(read_x)),
                                          rows)
            want_w = ((np.arange(n_mm)[:, None] * groups + g) * bk
                      + np.arange(bk)) * 8
            np.testing.assert_array_equal(np.sort(np.concatenate(read_w)),
                                          np.sort(want_w.reshape(-1)))
    return out


def _expected_share(tables, ci, c0, cw, form="mma"):
    """The block owning columns c0 .. c0 + cw of column block ci, counted
    from the term tables directly.  Dense form: (MM terms, digits, share
    bytes), 8 bytes per term (padded to 16), its tile slices, 4 bytes per
    digit, padded to 16.  List form: (entries per lane, 0, share bytes),
    the longest of its columns' nonzero folded weights over the lanes,
    4 bytes per word of every column and lane."""
    if form == "lists":
        col = _folded(tables)[:, ci * tables.block + c0:][:, :cw]
        lanes = _lanes(cw)
        per_lane = -(-int((col != 0).sum(0).max()) // lanes)
        return per_lane, 0, per_lane * cw * lanes * 4
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


_FORCE = {"mma": 0.0, "lists": math.inf}


def _rule(tables, cw):
    """The form the rule gives ``tables`` at slices of ``cw`` columns,
    counted from the term tables: lists for int8 when every folded weight
    fits 16 bits and the longest column's entries per lane are at most
    ``_LISTS_PER_MMA_UNIT`` x the busiest block's MMA units per warp (at
    least 1)."""
    if not tables.int8:
        return "mma"
    q = _folded(tables)
    if q.min() < -(1 << 15) or q.max() >= 1 << 15:
        return "mma"
    per_lane = -(-int((q != 0).sum(0).max()) // _lanes(cw))
    cp = tables.col_ptr_host
    n_mm = max(sum(1 for t in tables.terms_host[cp[ci]:cp[ci + 1]]
                   if t[0] == 0) for ci in range(tables.n_col_blocks))
    units = -(-n_mm * (cw // 8) // 8)
    return ("lists" if per_lane <= rr._LISTS_PER_MMA_UNIT * max(1, units)
            else "mma")


def _check_shares(tables, x, slice_options, monkeypatch=None, form=None):
    """Every slicing's shares against the tables, in the form the rule
    gives or, with ``form``, in that form (the rule's constant patched)."""
    if form is not None:
        monkeypatch.setattr(rr, "_LISTS_PER_MMA_UNIT", _FORCE[form])
    want = plain_recurrent_product(torch.as_tensor(x), tables).numpy()
    ncb, bk = tables.n_col_blocks, tables.block
    for slices in slice_options:
        shares = pack_blocks(tables, ncb * slices)
        assert shares.cw == bk // slices
        assert shares.form == (form if tables.int8 and form
                               else _rule(tables, shares.cw))
        offsets = np.cumsum([0] + list(shares.meta[:, 3]))
        assert (shares.meta[:, 0] == offsets[:-1]).all()
        assert (shares.meta[:, 0] % 16 == 0).all()
        for blk in range(ncb * slices):
            ci, sl = divmod(blk, slices)
            assert tuple(shares.meta[blk, 1:]) == _expected_share(
                tables, ci, sl * shares.cw, shares.cw, shares.form)
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


@pytest.mark.parametrize("form", ["mma", "lists"])
@pytest.mark.parametrize("kernel", ["generic", "specialized"])
@pytest.mark.parametrize("mode", ["int8-pn", "int8-csd"])
def test_both_int8_forms_decode_to_recurrent_product(monkeypatch, mode,
                                                     kernel, form):
    """Each int8 form forced on every slicing (the rule's constant patched
    to 0 or infinity): the dense tiles by their fragment layout, the lists
    word by word against the folded weights, both the exact product."""
    _j, _js, t_gen, t_spec = _pair(mode, "resident")
    tables = (t_gen if kernel == "generic" else t_spec).tables
    x = np.random.default_rng(8).integers(-128, 128, (3, DIM)).astype(
        np.int32)
    _check_shares(tables, x, (1, 2, 4, 8), monkeypatch, form)


def test_per_plane_terms_and_digits_fold_into_one_weight(monkeypatch):
    """B1's per-plane MM terms with their shifts and shift-add digits on
    the same row block fold into one list entry per (row, column): a
    weight the terms cancel leaves no entry, a digit on a tile's nonzero
    adds to it, and the lists give the exact product."""
    rng = np.random.default_rng(4)
    bk = 32
    data = np.zeros((1, 2, bk, bk), np.int8)
    mask = rng.random((2, bk, bk)) < 0.1
    data[0] = np.where(mask, rng.integers(-3, 4, (2, bk, bk)), 0)
    data[0, 0, 3, 4], data[0, 1, 3, 4] = 8, -1          # 8 + (-1 << 3) = 0
    data[0, 0, 5, 6], data[0, 1, 5, 6] = 1, 0
    data[0, :, 10, 11] = 0
    digits = ((5, 6, -1, 2), (7, 9, 1, 5), (10, 11, 1, 0))
    terms = ((MM, 0, 0, 0), (MM, 1, 3, 0), (SA, 0, digits))
    tables = build_tables((((0, terms),),), data, mode="int8",
                          n_col_blocks=1, device="cpu")
    q = _folded(tables)
    assert (q[3, 4], q[5, 6], q[10, 11]) == (0, 1 - 4, 1)
    assert q[7, 9] == int(data[0, 0, 7, 9]) + (int(data[0, 1, 7, 9]) << 3) \
        + 32
    monkeypatch.setattr(rr, "_LISTS_PER_MMA_UNIT", math.inf)
    for slices in (1, 2, 4):
        shares = pack_blocks(tables, slices)
        assert shares.form == "lists"
        assert shares.entries == int((q != 0).sum())
    x = rng.integers(-128, 128, (5, bk)).astype(np.int32)
    _check_shares(tables, x, (1, 2, 4), monkeypatch, "lists")
    # a weight beyond 16 bits keeps the dense form whatever the constant
    big = build_tables((((0, ((MM, 0, 9, 0),)),),), data[:, :1] * 0 + 100,
                       mode="int8", n_col_blocks=1, device="cpu")
    assert pack_blocks(big, 1).form == "mma"
    # all-zero tiles fold to no entries: empty lists, a share of 0 bytes
    empty = build_tables((((0, ((MM, 0, 0, 0),)),),), data[:, :1] * 0,
                         mode="int8", n_col_blocks=1, device="cpu")
    shares = pack_blocks(empty, 1)
    assert (shares.form, shares.entries) == ("lists", 0)
    assert shares.meta.tolist() == [[0, 0, 0, 0]]


@pytest.mark.parametrize("kernel", ["generic", "specialized"])
@pytest.mark.parametrize("regime", REGIMES)
def test_fp32_lane_partials_replay_recurrent_product(regime, kernel):
    """The fp32 kernel's split of every output's rows over warps and lanes
    (one per slicing: 8 to 64 columns a block at block 64), replayed on
    the shares: each row of each term read once per output, the sum within
    1e-5 of the twin's product."""
    _j, _js, t_gen, t_spec = _pair("fp32", regime)
    tables = (t_gen if kernel == "generic" else t_spec).tables
    x = np.random.default_rng(6).standard_normal((3, DIM)).astype(np.float32)
    want = plain_recurrent_product(torch.as_tensor(x), tables).numpy()
    for slices in (1, 2, 4, 8):
        shares = pack_blocks(tables, tables.n_col_blocks * slices)
        np.testing.assert_allclose(_replay_f32_lanes(tables, shares, x),
                                   want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cls", [FusedRollout, SpecializedRollout])
def test_fp32_lane_partials_at_paper_baseline(cls):
    """dim 800 in 7 x 7 blocks of 128 (the last column block 96 wide), on
    the default grid's 8-column slices and on one 128-column slice per
    column block: the kernel's lane reads cover every term row once and
    sum to the twin's product within 1e-5."""
    from repro_torch.configs.esn_paper import PAPER_BASELINE
    from repro_torch.core.esn import init_esn
    params = init_esn(PAPER_BASELINE, device="cpu")
    tables = cls(params.w.plan(), params.w_in, mode="fp32",
                 device="cpu").tables
    assert (tables.n_col_blocks, tables.block,
            tables.n_matmul_terms) == (7, 128, 49)
    x = np.zeros((2, tables.rows_pad), np.float32)
    x[:, :800] = np.random.default_rng(7).standard_normal((2, 800))
    want = plain_recurrent_product(torch.as_tensor(x), tables).numpy()
    for slices in (16, 1):
        shares = pack_blocks(tables, 7 * slices)
        np.testing.assert_allclose(_replay_f32_lanes(tables, shares, x),
                                   want, rtol=0, atol=1e-5)


def _pipelining(lower):
    """``lower(budget) -> (n_bands, tables)`` at the smallest budget of
    whole double-buffered tiles that pipelines."""
    for n in range(1, 256):
        try:
            n_bands, tables = lower(2 * n * BLOCK * BLOCK * 4)
        except ValueError:
            continue                    # a column's tiles overflow the band
        if n_bands > 1:
            return n_bands, tables
    raise AssertionError("no budget pipelines")


@pytest.mark.parametrize("kernel", ["generic", "specialized"])
@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_band_budget_leaves_the_kernels_shares_unchanged(mode, kernel):
    """Every thread block's share and its meta, what the CUDA kernel
    reads, are byte-identical whether the program was lowered unbanded,
    at the default budget or at a budget that pipelines: the budget only
    groups columns into bands, and the shares are cut per column."""
    rng = np.random.default_rng(0)
    plan = plan_for(FixedMatrix.compile(
        random_sparse_matrix(DIM, DIM, 0.9, rng) * 0.05, weight_bits=8,
        mode="csd", block=BLOCK, rng=rng))

    def lower(budget):
        if kernel == "generic":
            lay = plan.rollout_layout(mode, vmem_budget=budget)
            sched, data, n_bands = (generic_schedules(lay.band_plans()),
                                    lay.data, lay.n_bands)
        else:
            prog = specialize_rollout(plan, mode, vmem_budget=budget)
            sched, data, n_bands = prog.schedules, prog.data, prog.n_bands
        return n_bands, build_tables(sched, data, mode=mode,
                                     n_col_blocks=plan.nbc, device="cpu")

    n_bands, want = lower(None)
    assert n_bands == 1
    for _n_bands, got in (lower(DEFAULT_VMEM_BUDGET), _pipelining(lower)):
        for slices in (1, 8):
            a = pack_blocks(want, plan.nbc * slices)
            b = pack_blocks(got, plan.nbc * slices)
            assert a.blob.tobytes() == b.blob.tobytes()
            np.testing.assert_array_equal(a.meta, b.meta)


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


@pytest.mark.parametrize("n_blocks,b2_share,b1_per_lane,b1_lanes", [
    (128, 8 * 1024, 3, 32),
    (64, 16 * 1024, 5, 16),
    (32, 32 * 1024, 10, 8)])
def test_large_1024_grid_and_residency(large_1024, n_blocks, b2_share,
                                       b1_per_lane, b1_lanes):
    """At LARGE_1024 (8 column blocks of 128, 64 folded tiles for B2, 512
    plane tiles for B1, no digits; 52,276 nonzero weights) B2 keeps the
    dense form on every grid -- its longest column's entries per lane
    (3, 5, 10) exceed 1.5 x its MMA units per warp (1, 2, 4) -- and a
    block of 8 columns holds 8 KiB of its tiles beside 8 bytes per term
    (8 terms).  B1's 64 plane terms per column block (8, 16, 32 units per
    warp) fold into the same weights, so it takes the lists: per column
    ``lanes`` = 256 / cw lanes of 3, 5 and 10 words each at the longest,
    4 bytes a word, 3 / 5 / 10 KiB a block, resident at every grid (its
    dense 256 KiB share streamed at 32 blocks).  Shared memory: the
    mbarrier, 16 rows of the int8 state (1024 + 16 bytes each), three
    16 x cw arrays of 4-byte values (the int32 accumulator, u . W_in and
    x(n-1)), and the share when resident."""
    b2, b1, _f32 = large_1024
    assert (b2.n_matmul_terms, b2.n_digits, b1.n_matmul_terms) == (64, 0, 512)
    cw = 1024 // n_blocks
    base = 16 + 16 * 1040 + 16 * cw * 12
    grid = plan_grid(b2, _one_per_sm, n_blocks)
    share = 8 * 8 + b2_share
    assert (grid.n_blocks, grid.slices, grid.cw, grid.form) == (
        n_blocks, n_blocks // 8, cw, "mma")
    assert grid.share_bytes == share
    assert (grid.shares.meta[:, 1:] == (8, 0, share)).all()
    assert grid.resident and grid.shares.entries == 0
    assert grid.smem == base + share
    assert smem_bytes(b2, cw, share) == base + share
    grid = plan_grid(b1, _one_per_sm, n_blocks)
    share = b1_per_lane * cw * b1_lanes * 4
    meta = grid.shares.meta
    assert (grid.n_blocks, grid.slices, grid.cw, grid.form) == (
        n_blocks, n_blocks // 8, cw, "lists")
    assert grid.share_bytes == share and meta[:, 1].max() == b1_per_lane
    assert (meta[:, 2] == 0).all()
    assert (meta[:, 3] == meta[:, 1] * cw * b1_lanes * 4).all()
    assert grid.shares.entries == 52_276
    assert grid.shares.blob.nbytes == meta[:, 3].sum()
    assert grid.resident and grid.smem == base + share


def test_large_1024_default_grid(large_1024):
    """The default grid is the narrowest slicing the card holds at once:
    128 blocks of 8 columns on 132 SMs, whatever the tables' share and
    form (B2 dense, B1 lists, fp32 dense); with room for only 100 blocks
    it falls to 64.  fp32 stages 16 rows of 4 x 1024 + 16 bytes and keeps
    B1's 32 KiB of tiles (8 terms) resident.  Its 16 x 8 outputs keep
    u . W_in, x(n-1) and the 8 warps' partial sums of the fp32 product
    (8 x 4 bytes each)."""
    b2, b1, f32 = large_1024
    for tables, form in ((b2, "mma"), (b1, "lists"), (f32, "mma")):
        grid = plan_grid(tables, _one_per_sm)
        assert (grid.n_blocks, grid.form) == (128, form)
        assert plan_grid(tables, lambda smem: 100).n_blocks == 64
    grid = plan_grid(f32, _one_per_sm)
    assert (grid.share_bytes, grid.resident) == (64 + 32 * 1024, True)
    assert grid.smem == 16 + 16 * (4 * 1024 + 16) + 16 * 8 * (8 + 8 * 4) + \
        64 + 32 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        plan_grid(f32, lambda smem: 0)


@pytest.fixture(scope="module")
def esn4096_tables():
    """The paper's largest reservoir's shape (dim 4,096, 98 % of elements
    zero, block 128, int8-CSD; the seeded draw of the card's tests): B2's
    int8 tables, 1,024 folded tiles and the top plane's digits."""
    rng = np.random.default_rng(30)
    fm = FixedMatrix.compile(random_sparse_matrix(4096, 4096, 0.98, rng)
                             * 0.17, weight_bits=8, mode="csd", block=128,
                             rng=rng)
    return SpecializedRollout(fm, np.zeros((1, 4096), np.float32),
                              mode="int8", device="cpu").tables


def _h100(smem):
    """A 132-SM card holding two blocks an SM up to half its shared
    memory (what the occupancy API gives the int8 kernel), one beyond."""
    return (264 if smem <= 227 * 1024 // 2 else
            132 if smem <= 227 * 1024 else 0)


def test_rule_takes_lists_at_2_percent(esn4096_tables):
    """At 2 % nonzeros and dim 4,096 the default grid (256 blocks of 16
    columns) takes the lists: 8 entries a lane at the longest column
    against 8 MMA units a warp, ratio 1.0.  Its shares drop from ~65 KB
    of tiles and digits to 8 KiB of words and stay resident beside the
    68,880-byte footprint; no digit is left to scatter."""
    tables = esn4096_tables
    assert tables.n_matmul_terms == 1024 and tables.n_digits > 30_000
    grid = plan_grid(tables, _h100)
    assert (grid.n_blocks, grid.cw, grid.form, grid.resident) == (
        256, 16, "lists", True)
    assert rr._mma_units(tables, 16) == 8
    assert grid.shares.meta[:, 1].max() == 8
    assert grid.share_bytes == 8 * 16 * 16 * 4
    assert grid.smem == 68_880 + 8 * 1024
    assert (grid.shares.meta[:, 2] == 0).all()
    assert _rule(tables, 16) == "lists"


def test_rule_at_5_percent_and_50_percent(large_1024):
    """The rule at LARGE_1024's 5 %: B2 keeps the dense form (3 entries a
    lane against 1 MMA unit a warp: ratio 3 > 1.5) and B1, whose plane
    terms make 8 units a warp, takes the lists.  A 50 %-sparse int8 B2
    table keeps the dense form: 18 entries a lane (563 at the longest
    column) against 1 unit a warp."""
    b2, b1, _f32 = large_1024
    assert [plan_grid(t, _one_per_sm).form for t in (b2, b1)] == [
        "mma", "lists"]
    rng = np.random.default_rng(50)
    fm = FixedMatrix.compile(random_sparse_matrix(1024, 1024, 0.5, rng)
                             * 0.02, weight_bits=8, mode="csd", block=128,
                             rng=rng)
    half = SpecializedRollout(fm, np.zeros((1, 1024), np.float32),
                              mode="int8", device="cpu").tables
    grid = plan_grid(half, _one_per_sm)
    assert (grid.n_blocks, grid.form) == (128, "mma")
    assert grid.shares.meta[:, 1].max() == 8 and _rule(half, 8) == "mma"
    assert np.bincount(rr._folded_entries(half)[0]).max() == 563
