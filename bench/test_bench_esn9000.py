"""Pathak et al.'s Kuramoto-Sivashinsky reservoir (``esn9000-io64-csd``)
on the CPU: the cell's check at dim 1,000 with the published degree, the
published plan's tables and grid, and the configuration file's keys."""

import json

import numpy as np
import pytest
import torch

from bench.conftest import ROOT, SEED

CONFIGS = ROOT / "bench" / "configs"
CELL = "esn9000-io64-csd.stream"


def _h100_capacity(smem: int) -> int:
    """Blocks of ``smem`` bytes an H100 holds at once: 132 SMs of 228 KiB
    (1 KiB of it reserved per block), at most 8 blocks of 256 threads an
    SM, at most 227 KiB a block."""
    if smem > 227 * 1024:
        return 0
    return 132 * min(8, 228 * 1024 // (smem + 1024))


@pytest.fixture
def cell_1000(tiny):
    """The cell at dim 1,000 and 3 links a node, the published degree.
    (``tiny``'s dim 192 at the published sparsity leaves ~12 nonzeros, a
    graph with no cycle, whose spectral radius 0 the weights cannot be
    rescaled to.)"""
    cell = tiny(CELL)
    cell.cfg.update(reservoir_dim=1000, element_sparsity=1 - 3 / 1000)
    return cell


def _state_unchanged(self, u, x0b, with_readout, with_final, donate=False):
    y = (x0b @ self.params.w_out)[:, None, :].expand(
        -1, u.shape[1], -1).contiguous()
    return y, (x0b if with_final else None)


def _answer_altered(orig):
    def dispatch(self, u, x0b, *a, **kw):
        y, xf = orig(self, u, x0b, *a, **kw)
        y = y.clone()
        y[:, -1] += 1.0
        return y, xf
    return dispatch


def test_sound_run_is_correct_and_the_control_is_not(cell_1000):
    from bench.harness import run_cell
    out = run_cell(cell_1000, SEED, 0.3, False, device="cpu", control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["_control"] > out["checks"]["pred_err"]["limit"]


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_planted_fault_is_not_correct(cell_1000, fault, monkeypatch):
    """A step that returns its state unchanged, an answer altered where
    it is produced: neither is correct under the configuration's limit."""
    from bench.harness import run_cell
    from repro_torch.serve.engine import ReservoirEngine
    patched = (_state_unchanged if fault == "state_unchanged"
               else _answer_altered(ReservoirEngine._dispatch))
    monkeypatch.setattr(ReservoirEngine, "_dispatch", patched)
    out = run_cell(cell_1000, SEED, 0.3, False, device="cpu")
    assert not out["correct"]
    assert out["failed"] > 0


def test_published_plan_tables_and_grid():
    """At dim 9,000 and 3 links a node (a seeded draw; the spectral
    radius's rescale does not change the quantized matrix): ~27,000
    nonzeros, ~5 a 128 x 128 tile, none reaching the crossover of 64, so
    no MM term and ~78,000 shift-add digits.  On an H100's capacity the
    16 staged state rows (170,256 bytes a block at 128 columns, 157,968
    at 64) let one block onto an SM, so 142 blocks of 64 columns do not
    fit and the default grid is 71 blocks of 128 columns, resident, in
    the dense form with no tile (the longest column's entries per lane
    exceed the list rule's floor of one MMA unit) and the ``shared``
    readout."""
    from repro_torch.core.sparse import FixedMatrix
    from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
        blocks_per_sm, launch_counts, plan_grid, readout_path, smem_bytes)
    from repro_torch.kernels.reservoir_rollout.specialized import \
        SpecializedRollout
    cfg = json.loads((CONFIGS / "esn9000-io64-csd.json").read_text())
    dim = cfg["reservoir_dim"]
    rng = np.random.default_rng(SEED)
    dense = rng.uniform(-1, 1, (dim, dim)) * (
        rng.random((dim, dim)) >= cfg["element_sparsity"])
    nnz = int(np.count_nonzero(dense))
    fm = FixedMatrix.compile(dense, weight_bits=cfg["weight_bits"],
                             mode="csd", block=cfg["block"], rng=rng)
    del dense
    op = SpecializedRollout(fm, torch.zeros((1, dim)), mode="int8",
                            device="cpu")
    tables = op.tables
    assert 26_000 < nnz < 28_000
    assert op.program.crossover == 64
    assert tables.n_matmul_terms == 0
    assert 70_000 < tables.n_digits < 86_000
    grid = plan_grid(tables, _h100_capacity)
    assert (grid.n_blocks, grid.cw, grid.form, grid.resident) == (
        71, 128, "mma", True)
    base = smem_bytes(tables, 128)
    assert base == 170_256 and grid.smem == base + grid.share_bytes
    assert _h100_capacity(smem_bytes(tables, 64)) == 132 < 142
    assert blocks_per_sm(_h100_capacity, grid.smem, 132) == 1
    assert readout_path(grid.cw) == "shared"
    assert launch_counts(grid, 3, 1, 16) == (0, 3 * tables.n_digits, 3)


def test_config_keys_equal_the_other_files():
    files = sorted(CONFIGS.glob("*.json"))
    keys = {f.name: set(json.loads(f.read_text())) for f in files}
    assert "esn9000-io64-csd.json" in keys and len(keys) >= 4
    assert len({frozenset(k) for k in keys.values()}) == 1, keys
    cfg = json.loads((CONFIGS / "esn9000-io64-csd.json").read_text())
    assert (cfg["reservoir_dim"], cfg["input_dim"], cfg["output_dim"],
            cfg["element_sparsity"], cfg["spectral_radius"],
            cfg["input_scale"], cfg["leak"], cfg["mode"], cfg["weight_bits"],
            cfg["state_bits"], cfg["block"]) == (
                9000, 64, 64, 1 - 3 / 9000, 0.4, 0.5, 1.0, "int8-csd", 8, 8,
                128)
