"""How ``correct`` is decided, held at a size the CPU holds: the reference
against the port, the control and the planted faults coming out not
correct, and what a run may import."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench.conftest import ROOT, SEED

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("config", ["esn1024-csd95", "esn800-fp32"])
def test_reference_agrees_with_the_port_on_the_cpu(config, tiny):
    """The reference and the port's CPU path (its kernels' plain twins)
    over the same seed's weights and inputs."""
    from bench.harness import build_program
    from bench.reference import esn as reference
    from bench.weights import make_weights
    cell = tiny(f"{config}.stream")
    cfg = cell.cfg
    w = make_weights(cfg, SEED, "cpu")
    engine = build_program(cfg, w, SEED, "cpu")
    rng = np.random.default_rng(0)
    inputs = [rng.uniform(-1, 1, (t, 1)).astype(np.float32)
              for t in (40, 17, 64)]
    spec = {k: cfg[k] for k in ("mode", "weight_bits", "state_bits", "leak")}
    refs = reference.rollout(spec, w.dense, w.w_in, w.w_out, inputs)
    scale = max(np.abs(r).max() for r in refs)
    for u, ref in zip(inputs, refs):
        got = engine.predictions(u).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(cell, tiny):
    from bench.harness import run_cell
    out = run_cell(tiny(cell), SEED, 0.3, False, device="cpu", control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["_control"] > out["checks"]["pred_err"]["limit"]
    assert list(out)[-2:] == ["checks", "_stderr"]


def _state_unchanged(orig):
    def dispatch(self, u, x0b, with_readout, with_final, donate=False):
        y = (x0b @ self.params.w_out)[:, None, :].expand(
            -1, u.shape[1], -1).contiguous()
        return y, (x0b if with_final else None)
    return dispatch


def _answer_altered(orig):
    def dispatch(self, u, x0b, *a, **kw):
        y, xf = orig(self, u, x0b, *a, **kw)
        y = y.clone()
        y[:, -1] += 1.0
        return y, xf
    return dispatch


FAULTS = [(c, f) for c in CELLS for f in ("state_unchanged", "answer_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_not_correct(cell, fault, tiny, monkeypatch):
    """The timed path broken underneath the harness: a step that returns
    its state unchanged, an answer altered where it is produced.  The
    stream's batch is one row, so there is no half of it to leave out;
    one chip, so no exchange between chips to leave out."""
    from bench.harness import run_cell
    from repro_torch.serve.engine import ReservoirEngine
    make = {"state_unchanged": _state_unchanged,
            "answer_altered": _answer_altered}[fault]
    monkeypatch.setattr(ReservoirEngine, "_dispatch",
                        make(ReservoirEngine._dispatch))
    out = run_cell(tiny(cell), SEED, 0.3, False, device="cpu")
    assert not out["correct"]
    assert out["failed"] > 0


def test_reference_imports_nothing_of_the_program():
    banned = {"repro", "repro_torch", "jax", "jaxlib", "flax", "bench"}
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".", 1)[0] not in banned, (path.name, n)


IMPORT_CHECK = r"""
import sys
sys.path[:0] = [{src!r}, {root!r}]
from bench.conftest import SEED, shrink
from bench.harness import load_cell, run_cell
from bench.run import forbidden_modules
for name in {cells!r}:
    out = run_cell(shrink(load_cell(name)), SEED, 0.2, False,
                   device="cpu")
    assert out["correct"], out["checks"]
print("FORBIDDEN", forbidden_modules())
"""


def test_a_run_loads_no_jax():
    """The harness's set-up, traffic and check at a tiny size, in a fresh
    process: no module whose top-level name is ``jax``, ``jaxlib``,
    ``flax`` or ``repro`` (as a whole name) is loaded afterwards."""
    code = IMPORT_CHECK.format(src=str(ROOT / "src"), root=str(ROOT),
                               cells=CELLS)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "FORBIDDEN []"


def test_forbidden_names_are_whole_top_level_names():
    from bench.run import FORBIDDEN
    assert "repro" in FORBIDDEN and "repro_torch" not in FORBIDDEN
    assert "repro_torch.serve".split(".", 1)[0] not in FORBIDDEN
    assert "jax.numpy".split(".", 1)[0] in FORBIDDEN


def test_run_refuses_without_a_gpu_or_the_port(tmp_path):
    """No CUDA device: a non-zero exit and no result, never the CPU.
    A directory with only BENCHMARK.json and ``bench/``: the same."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")
    cmd = [sys.executable, "bench/run.py", "--workload", CELLS[0],
           "--seed", str(SEED), "--seconds", "1", "--trace", "0"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    import shutil
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_gpu(cell, tiny):
    """The sound run and the control of each cell, shrunk, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bench.harness import run_cell
    out = run_cell(tiny(cell), SEED, 0.5, False,
                   device=torch.device("cuda", 0), control=True)
    assert out["correct"], out["checks"]
    assert out["_control"] > out["checks"]["pred_err"]["limit"]
