"""The port's request-path spans on the CPU.

One ``ReservoirEngine.submit`` records one span tree: ``request.serve``
over ``engine.prepare``, ``rollout.launch`` (the kernels layer, here the
cuda backend's plain twin) and ``engine.sync``, sharing the request's
trace id, each naming its parent and nested in time.  ``run_segment``
records the launch and the sync with no root.  Tracing off records
nothing and reads the clock no more than the request's timings need;
events and spans share ``time.perf_counter``; the span, histogram and
event this path no longer emits stay gone.  The rollout kernels' grid
event and counters: what :func:`launch_counts` gives on resident and
streamed shares in either form of the int8 shares, and what the
card-only launch path records, driven on the CPU with the library
stubbed out.
"""

import contextlib
import math
import pathlib
import re
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.esn import ESNConfig, init_esn
from repro_torch.serve import ReservoirEngine, SubmitSpec

CHILDREN = ("engine.prepare", "rollout.launch", "engine.sync")
REMOVED_SPANS = ("engine.rollout", "engine.dispatch")
PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture(autouse=True)
def _obs_off():
    obs.disable()
    yield
    obs.disable()


@pytest.fixture(scope="module")
def engine():
    params = init_esn(ESNConfig(reservoir_dim=64, element_sparsity=0.8,
                                seed=3), device="cpu")
    return ReservoirEngine(params, backend="cuda", device="cpu")


def _inputs(t, seed=0):
    return np.random.default_rng(seed).standard_normal((t, 1)).astype(
        np.float32)


def test_submit_records_one_span_tree(engine):
    obs.configure()
    results = [engine.submit(SubmitSpec(_inputs(t, t), want_states=True))
               for t in (5, 9)]
    spans = obs.tracer().spans()
    ids = [r.timings["trace_id"] for r in results]
    assert ids[0] and ids[1] and ids[0] != ids[1]
    assert {s.trace_id for s in spans} == set(ids)
    for res, tid in zip(results, ids):
        tree = obs.tracer().spans(trace_id=tid)
        assert [s.name for s in tree] == list(CHILDREN) + ["request.serve"]
        root = tree[-1]
        assert root.parent is None and root.clock == "wall"
        assert root.attrs == {"batch": 1, "steps": res.states.shape[0]}
        # the root is the request's own interval, and the histogram's
        assert root.start == res.timings["arrival_time"]
        assert root.end == res.timings["finish_time"]
        assert root.duration_s == res.timings["seconds"]
        last = root.start
        for child in tree[:-1]:
            assert child.parent == "request.serve" and child.trace_id == tid
            assert last <= child.start <= child.end <= root.end
            last = child.end
        launch = tree[1]
        assert launch.attrs == {"kernel": "specialized_rollout"}
    hist = obs.metrics().histogram("request_latency_seconds")
    assert hist.count(path="engine") == 2
    assert hist.data(path="engine").sum == pytest.approx(
        sum(r.timings["seconds"] for r in results))
    assert len(obs.tracer().spans(name="rollout.launch")) == 2


def test_run_segment_launch_has_no_trace_id(engine):
    obs.configure()
    x0 = torch.zeros((2, 64))
    u = torch.as_tensor(np.stack([_inputs(4, 1), _inputs(4, 2)]))
    engine.run_segment(u, x0, want_states=True)
    spans = obs.tracer().spans()
    assert [s.name for s in spans] == ["rollout.launch", "engine.sync"]
    for s in spans:
        assert s.trace_id is None and s.parent is None
    # a deferred segment has no sync to time
    obs.configure()
    engine.run_segment(u, x0, want_states=True, defer_sync=True)
    assert [s.name for s in obs.tracer().spans()] == ["rollout.launch"]


def test_off_records_nothing_and_reads_the_clock_three_times(engine,
                                                            monkeypatch):
    reads = []
    clock = time.perf_counter

    def counted():
        reads.append(1)
        return clock()

    monkeypatch.setattr(time, "perf_counter", counted)
    res = engine.submit(SubmitSpec(_inputs(6), want_states=True))
    # the request's entry, the rollout's end (its stats) and its return
    assert len(reads) == 3 and res.timings.get("trace_id") is None
    assert obs.tracer() is None and obs.events() is None
    reads.clear()
    obs.configure()
    engine.submit(SubmitSpec(_inputs(6), want_states=True))
    assert len(reads) > 3
    monkeypatch.undo()
    # a fresh tracer starts with no span, and nothing was left open
    obs.configure()
    assert len(obs.tracer()) == 0
    engine.submit(SubmitSpec(_inputs(6), want_states=True))
    assert obs.tracer().spans(name="request.serve")[0].parent is None


def test_failed_submit_closes_its_root(engine):
    obs.configure()
    with pytest.raises(Exception):
        engine.submit(SubmitSpec(np.zeros((2, 3, 4, 5), np.float32),
                                 want_states=True))
    *done, root = obs.tracer().spans()
    assert root.name == "request.serve" and root.attrs == {"failed": True}
    assert all(s.parent == "request.serve" for s in done)
    engine.submit(SubmitSpec(_inputs(3), want_states=True))
    roots = obs.tracer().spans(name="request.serve")
    assert roots[1].parent is None and roots[1].trace_id != root.trace_id


def test_open_spans_nest_and_inherit():
    tr = obs.Tracer()
    tr.open("outer", 1.0, trace_id="t-x")
    tr.record("leaf", 1.5, 2.0)
    tr.open("inner", 2.0)
    tr.record("deep", 2.1, 2.2, trace_id="mine")
    tr.close(3.0)
    tr.close(4.0)
    tr.record("after", 5.0, 6.0)
    got = {s.name: (s.parent, s.trace_id) for s in tr.spans()}
    assert got == {"leaf": ("outer", "t-x"), "deep": ("inner", "mine"),
                   "inner": ("outer", "t-x"), "outer": (None, "t-x"),
                   "after": (None, None)}
    (inner,), (outer,) = tr.spans(name="inner"), tr.spans(name="outer")
    assert (inner.start, inner.end, outer.start, outer.end) == (
        2.0, 3.0, 1.0, 4.0)
    with tr.span("block"):
        tr.record("in_block", 7.0)
    assert tr.spans(name="in_block")[0].parent == "block"
    assert tr.spans(name="block")[0].as_dict()["parent"] is None
    # the ring drops the oldest, and counts every drop over its life
    ring = obs.Tracer(capacity=2)
    for k in range(3):
        ring.record(f"s{k}", float(k))
    assert [s.name for s in ring.spans()] == ["s1", "s2"]
    assert ring.dropped == 1
    ring.clear()
    ring.record("a", 0.0)
    ring.record("b", 0.0)
    assert ring.dropped == 1 and len(ring) == 2
    ring.record("c", 0.0)
    assert ring.dropped == 2


def test_event_ts_is_on_the_span_clock():
    obs.configure()
    a = time.perf_counter()
    obs.event("probe", value=1)
    b = time.perf_counter()
    (ev,) = obs.events().events("probe")
    assert a <= ev.ts <= b and ev.as_dict()["ts"] == ev.ts


def test_removed_names_are_not_emitted(engine):
    obs.configure()
    engine.submit(SubmitSpec(_inputs(5), want_states=True))
    u = torch.as_tensor(_inputs(4)[None])
    engine.run_segment(u, torch.zeros((1, 64)), want_states=True)
    engine.run_segment(u, torch.zeros((1, 64)), want_states=True,
                       defer_sync=True)
    engine.rollout(_inputs(4))
    names = {s.name for s in obs.tracer().spans()}
    assert names == {"request.serve", *CHILDREN}
    assert not names & set(REMOVED_SPANS)
    assert obs.metrics().get("engine_rollout_seconds") is None
    assert "engine_rollout_seconds" not in obs.metrics().prometheus_text()
    assert obs.events().count("kernel_launch") == 0
    assert not obs.events().events("kernel_launch")


def test_no_writer_of_the_removed_names_is_left():
    """The card-only launch path is out of the CPU's reach: no source
    line of the port names what it no longer emits."""
    gone = re.compile(r"""["'](engine\.rollout|engine\.dispatch|"""
                      r"""engine_rollout_seconds|kernel_launch)["']""")
    hits = [f"{p.relative_to(PORT)}:{i}"
            for p in sorted(PORT.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if gone.search(line)]
    assert hits == []


# -- the rollout kernels' grid event and counters ------------------------------
def _digit_tables():
    """dim 256, block 32, 97 % zeros: B2's tables with shift-add digits,
    on the CPU."""
    from repro_torch.core.sparse import FixedMatrix, random_sparse_matrix
    from repro_torch.kernels.reservoir_rollout.specialized import \
        SpecializedRollout
    rng = np.random.default_rng(0)
    fm = FixedMatrix.compile(random_sparse_matrix(256, 256, 0.97, rng) * 0.05,
                             weight_bits=8, mode="csd", block=32, rng=rng)
    op = SpecializedRollout(fm, np.zeros((1, 256), np.float32), mode="int8",
                            device="cpu")
    assert op.tables.n_digits > 0
    return op.tables


_FORCE = {"mma": 0.0, "lists": math.inf}


def _force(monkeypatch, form):
    """Pack int8 shares in ``form``: the rule's constant at 0 or
    infinity."""
    from repro_torch.kernels.reservoir_rollout import reservoir_rollout as rr
    monkeypatch.setattr(rr, "_LISTS_PER_MMA_UNIT", _FORCE[form])


@pytest.mark.parametrize("form", ["mma", "lists"])
@pytest.mark.parametrize("resident", [True, False])
def test_launch_counts_resident_and_streamed(monkeypatch, resident, form):
    """Resident shares stream nothing beyond the one bulk copy; streamed
    ones are read whole by every block once per batch tile per step (20
    rows in tiles of 16: two).  In the dense form each digit is scattered
    once per batch row per step either way; the list form folds its
    digits into the weights and scatters none.  The product runs once per
    step per batch row in both."""
    from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
        launch_counts, plan_grid, smem_bytes)
    _force(monkeypatch, form)
    tables = _digit_tables()
    # 32 blocks of 8 columns; streamed: room for the blocks without shares
    room = 10 ** 6 if resident else smem_bytes(tables, 8)
    grid = plan_grid(tables, lambda smem: 64 if smem <= room else 0)
    assert (grid.n_blocks, grid.cw, grid.form) == (32, 8, form)
    assert grid.resident is resident
    share_total = int(grid.shares.meta[:, 3].sum())
    assert share_total == grid.shares.blob.nbytes
    streamed, digits, rows = launch_counts(grid, 7, 20, 16)
    assert digits == (tables.n_digits * 7 * 20 if form == "mma" else 0)
    assert streamed == (0 if resident else share_total * 7 * 2)
    assert rows == 7 * 20
    assert launch_counts(grid, 7, 16, 16)[0] == streamed // 2


def _fake_card(monkeypatch):
    """The kernels layer's launch path on the CPU: the library, the
    device context and the stream stand in for the card's (the launch
    runs nothing), and the capacity is a 132-SM card's, one block an SM."""
    from repro_torch.kernels.reservoir_rollout import reservoir_rollout as rr

    class Lib:
        def rollout_run(self, *args):
            return 0

    class Library:
        def load(self):
            return Lib()

    monkeypatch.setattr(rr, "require_cuda", lambda t: None)
    monkeypatch.setattr(rr, "stream", lambda dev: 0)
    monkeypatch.setattr(rr._cuda, "LIBRARY", Library())
    monkeypatch.setattr(rr, "_device_capacity", lambda int8, dev: (
        lambda smem: 132 if smem <= 227 * 1024 else 0))
    monkeypatch.setattr(rr, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    return rr


def _launch(rr, tables, t, b, **kw):
    from repro_torch.kernels.reservoir_rollout.specialized import \
        specialized_rollout
    return rr._launch_rollout(
        specialized_rollout, torch.zeros((t, b, 1)), tables,
        torch.zeros((1, 256)), torch.zeros((b, 256)), torch.zeros((256, 1)),
        b_tile=min(b, 16), **{"want_states": False, "want_preds": True,
                              **kw})


@pytest.mark.parametrize("form", ["mma", "lists"])
def test_rollout_grid_event_and_counters(monkeypatch, form):
    """One ``rollout_grid`` event per grid built, with the grid's
    geometry, its form and list entries, the table's terms and the
    occupancy it was planned at (one block an SM on the stand-in); each
    launch adds what :func:`launch_counts` says to the three counters,
    under its kernel's name (product rows also under the form): digits
    scattered only by the dense form, steps x rows of the product by
    either."""
    rr = _fake_card(monkeypatch)
    _force(monkeypatch, form)
    tables = _digit_tables()
    obs.configure()
    _launch(rr, tables, 5, 3)
    _launch(rr, tables, 9, 20)
    grid, _ = rr.rollout_grid(tables, torch.device("cpu"))
    assert grid.form == form
    (ev,) = obs.events().events("rollout_grid")
    assert ev.fields == dict(
        mode="int8", n_blocks=grid.n_blocks, cw=grid.cw,
        resident=grid.resident, share_bytes=grid.share_bytes,
        smem=grid.smem, blob_bytes=grid.shares.blob.nbytes,
        mm_terms=tables.n_matmul_terms, digits=tables.n_digits, form=form,
        list_entries=grid.shares.entries, blocks_per_sm=1)
    assert (grid.shares.entries > 0) is (form == "lists")
    want = [a + b for a, b in zip(rr.launch_counts(grid, 5, 3, 3),
                                  rr.launch_counts(grid, 9, 20, 16))]
    m = obs.metrics()
    got = [m.get(name).value(kernel="specialized_rollout")
           for name in ("rollout_streamed_bytes_total",
                        "rollout_shiftadd_digits_total")]
    rows = m.get("rollout_product_rows_total")
    got.append(rows.value(kernel="specialized_rollout", form=form))
    assert got == want and want[2] == 5 * 3 + 9 * 20
    assert want[1] == (tables.n_digits * (5 * 3 + 9 * 20) if form == "mma"
                       else 0)
    assert rows.value() == want[2]


def test_rollout_sites_record_nothing_when_off(monkeypatch):
    """With ``obs`` off a launch records nothing and never counts."""
    rr = _fake_card(monkeypatch)

    def refuse(*a):
        raise AssertionError("launch_counts called with obs off")

    monkeypatch.setattr(rr, "launch_counts", refuse)
    _launch(rr, _digit_tables(), 4, 2)
    assert obs.active() is None
    obs.configure()
    assert len(obs.events()) == 0 and obs.metrics().families() == []


def _block128_tables():
    """dim 256 in two column blocks of 128: B2's int8 tables on the CPU,
    whose grids of 32, 16, 8, 4 and 2 blocks give slices of 8 to 128
    columns."""
    from repro_torch.core.sparse import FixedMatrix, random_sparse_matrix
    from repro_torch.kernels.reservoir_rollout.specialized import \
        SpecializedRollout
    rng = np.random.default_rng(31)
    fm = FixedMatrix.compile(random_sparse_matrix(256, 256, 0.95, rng) * 0.05,
                             weight_bits=8, mode="csd", block=128, rng=rng)
    return SpecializedRollout(fm, np.zeros((1, 256), np.float32),
                              mode="int8", device="cpu").tables


@pytest.mark.parametrize("n_blocks,cw,path", [
    (32, 8, "shuffle"), (16, 16, "shuffle"), (8, 32, "shuffle"),
    (4, 64, "shared"), (2, 128, "shared")])
def test_readout_rows_counter_follows_cw(monkeypatch, n_blocks, cw, path):
    """``rollout_readout_rows_total`` adds readout steps x batch rows per
    launch under the grid's readout path, ``"shared"`` only for slices
    wider than 32 columns; a launch with ``obs`` off and one without
    predictions add nothing."""
    rr = _fake_card(monkeypatch)
    tables = _block128_tables()
    assert rr.readout_path(cw) == path
    _launch(rr, tables, 8, 3, n_blocks=n_blocks)          # obs off
    obs.configure()
    _launch(rr, tables, 12, 3, n_blocks=n_blocks, readout_every=4)
    _launch(rr, tables, 5, 20, n_blocks=n_blocks)
    _launch(rr, tables, 6, 2, n_blocks=n_blocks, want_preds=False,
            want_final=True)
    grid, _ = rr.rollout_grid(tables, torch.device("cpu"), n_blocks)
    assert (grid.n_blocks, grid.cw) == (n_blocks, cw)
    rows = obs.metrics().get("rollout_readout_rows_total")
    assert rows.value(kernel="specialized_rollout", path=path) == (
        12 // 4 * 3 + 5 * 20)
    assert rows.value() == 12 // 4 * 3 + 5 * 20


def test_io_macs_counter_follows_io_macs(monkeypatch):
    """``rollout_io_macs_total`` adds :func:`io_macs` per launch: the
    input projection's steps x rows x dim x I under ``part="input"``
    always, the readout's readout steps x rows x dim x O under
    ``part="readout"`` only with predictions; nothing with ``obs`` off."""
    rr = _fake_card(monkeypatch)
    tables = _digit_tables()
    _launch(rr, tables, 8, 3)                             # obs off
    obs.configure()
    _launch(rr, tables, 12, 3, readout_every=4)
    _launch(rr, tables, 6, 2, want_preds=False, want_final=True)
    macs = obs.metrics().get("rollout_io_macs_total")
    got = {part: macs.value(kernel="specialized_rollout", part=part)
           for part in ("input", "readout")}
    want_in = rr.io_macs(12, 3, 256, 1, 1, 3)[0] + rr.io_macs(
        6, 2, 256, 1, 1, 0)[0]
    assert got == {"input": want_in, "readout": 12 // 4 * 3 * 256}
    assert want_in == (12 * 3 + 6 * 2) * 256
