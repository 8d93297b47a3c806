"""The paper's largest reservoir (``esn4096-csd98``) on the CPU: the port
against the reference on a plan of the same kind, the published plan's
tables and grid, and the configuration file's keys."""

import json

import numpy as np
import torch

from bench.conftest import ROOT, SEED

CONFIGS = ROOT / "bench" / "configs"


def _h100_capacity(smem: int) -> int:
    """Blocks of ``smem`` bytes an H100 holds at once: 132 SMs of 228 KiB
    (1 KiB of it reserved per block), at most 8 blocks of 256 threads an
    SM, at most 227 KiB a block."""
    if smem > 227 * 1024:
        return 0
    return 132 * min(8, 228 * 1024 // (smem + 1024))


def test_reference_agrees_with_the_port_at_dim_512(tiny):
    """dim 512, 98 % sparse, block 128: 16 kept tiles of ~328 nonzeros
    each, as at dim 4,096, so the CSD top plane's few digits become
    shift-add terms.  The harness's engine (on the CPU ``"auto"`` is the
    torch backend) and the cuda backend's engine over the same weights
    (B2's plain twin, which scatters the digits) both agree with the
    reference within ``test_reference_agrees_with_the_port_on_the_cpu``'s
    1e-5 of the answers' scale: the reference works in float64 and the
    port in float32 around the same exact integer product."""
    from bench.harness import build_program
    from bench.reference import esn as reference
    from bench.weights import make_weights
    from repro_torch.serve import ReservoirEngine
    cfg = tiny("esn4096-csd98.stream").cfg
    cfg.update(reservoir_dim=512)
    w = make_weights(cfg, SEED, "cpu")
    engine = build_program(cfg, w, SEED, "cpu")
    b2 = ReservoirEngine(engine.params, backend="cuda", device="cpu")
    assert b2.program.n_matmul_terms == 16
    assert b2.program.shiftadd_digits > 0
    rng = np.random.default_rng(0)
    inputs = [rng.uniform(-1, 1, (t, 1)).astype(np.float32)
              for t in (40, 17, 64)]
    spec = {k: cfg[k] for k in ("mode", "weight_bits", "state_bits", "leak")}
    refs = reference.rollout(spec, w.dense, w.w_in, w.w_out, inputs)
    scale = max(np.abs(r).max() for r in refs)
    for u, ref in zip(inputs, refs):
        for eng in (engine, b2):
            got = eng.predictions(u).numpy()
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


def test_published_plan_tables_and_grid():
    """At dim 4,096 and 98 % (a seeded draw; the spectral radius's
    rescale does not change the quantized matrix): all 1,024 blocks are
    kept as folded tiles, the shift-add digits are the CSD top plane's
    (shift 7) alone, and on an H100's capacity the default grid is 256
    blocks of 16 columns whose ~66 KB shares stream from global memory:
    with its share a block needs ~135 KB, one a SM, 132 < 256."""
    from repro_torch.core.sparse import FixedMatrix
    from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
        launch_counts, plan_grid, smem_bytes)
    from repro_torch.kernels.reservoir_rollout.specialized import \
        SpecializedRollout
    cfg = json.loads((CONFIGS / "esn4096-csd98.json").read_text())
    dim = cfg["reservoir_dim"]
    rng = np.random.default_rng(SEED)
    dense = rng.uniform(-1, 1, (dim, dim)) * (
        rng.random((dim, dim)) >= cfg["element_sparsity"])
    fm = FixedMatrix.compile(dense, weight_bits=cfg["weight_bits"],
                             mode="csd", block=cfg["block"], rng=rng)
    op = SpecializedRollout(fm, torch.zeros((1, dim)), mode="int8",
                            device="cpu")
    tables = op.tables
    assert op.program.crossover == 64
    assert tables.n_matmul_terms == 1024
    assert tables.n_digits > 30_000
    assert set(tables.digits_host[:, 3].tolist()) == {7}
    grid = plan_grid(tables, _h100_capacity)
    assert (grid.n_blocks, grid.cw, grid.resident) == (256, 16, False)
    base = smem_bytes(tables, 16)
    assert base == 16 + 16 * (4096 + 16) + 16 * 16 * 12 == grid.smem
    assert 60_000 < grid.share_bytes and _h100_capacity(
        base + grid.share_bytes) < 256
    meta = grid.shares.meta
    assert (meta[:, 1] == 32).all() and meta[:, 2].sum() == tables.n_digits
    assert launch_counts(grid, 3, 1, 16) == (3 * int(meta[:, 3].sum()),
                                             3 * tables.n_digits)


def test_config_keys_equal_the_other_files():
    files = sorted(CONFIGS.glob("*.json"))
    keys = {f.name: set(json.loads(f.read_text())) for f in files}
    assert "esn4096-csd98.json" in keys and len(keys) >= 3
    assert len({frozenset(k) for k in keys.values()}) == 1, keys
    cfg = json.loads((CONFIGS / "esn4096-csd98.json").read_text())
    assert (cfg["reservoir_dim"], cfg["element_sparsity"], cfg["mode"],
            cfg["weight_bits"], cfg["state_bits"], cfg["block"]) == (
                4096, 0.98, "int8-csd", 8, 8, 128)
