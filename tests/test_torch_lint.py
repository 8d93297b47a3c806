"""Import lint: the PyTorch port stands alone.

Nothing under ``src/repro_torch/`` — and not ``chip_smoke.py``, the
scripts under ``tools/`` or the port's examples (``examples/*_torch.py``)
— may import ``jax`` or the JAX package (``repro`` / ``repro.*``), not
even its numpy-only modules: importing any ``repro.core`` module pulls
JAX in through the package ``__init__``.  Checked statically over every
source file, and dynamically by importing the whole port in a fresh
interpreter.  Every example script of the JAX package has its twin.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = ROOT / "examples"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "tools").glob("*.py"))
         + sorted(EXAMPLES.glob("*_torch.py")))
REFERENCE_EXAMPLES = sorted(p for p in EXAMPLES.glob("*.py")
                            if not p.stem.endswith("_torch"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("script", REFERENCE_EXAMPLES,
                         ids=[p.name for p in REFERENCE_EXAMPLES])
def test_every_reference_example_has_a_twin(script):
    assert (EXAMPLES / f"{script.stem}_torch.py").is_file(), (
        f"examples/{script.name} has no examples/{script.stem}_torch.py")


def test_port_imports_without_jax():
    """Importing every port module leaves jax and repro unloaded."""
    mods = sorted({".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                   .removesuffix(".__init__")
                   for p in PORT.rglob("*.py")})
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'repro')]\n"
              "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_lint_catches_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy\nfrom repro.core import csd\n"
                   "import jax.numpy as jnp\nfrom repro_torch import obs\n")
    assert [n for n in _imports(bad) if _forbidden(n)] == [
        "repro.core", "jax.numpy"]
