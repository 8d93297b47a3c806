"""CPU tests of the benchmark harness: ``python -m pytest bench``.

They import the port from ``src`` and the harness as the package
``bench``; every cell they run is cut to a size the CPU holds (``tiny``),
with the port's plain PyTorch twins in place of the CUDA kernels.
"""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 3_000_000_019        # above 2**31: a seed is any whole number


def shrink(cell):
    """A cell cut to the CPU: dim 192 (two column blocks), requests of
    16-64 steps."""
    cell.cfg.update(reservoir_dim=192)
    cell.mix["lengths"]["values"] = [16, 40, 64]
    return cell


@pytest.fixture
def tiny():
    """``tiny(name)``: the cell ``name`` of ``BENCHMARK.json``, shrunk to
    the CPU."""
    from bench.harness import load_cell
    return lambda name: shrink(load_cell(name, ROOT))
