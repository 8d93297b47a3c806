"""The port's public names against the JAX package's, and the repaired ones.

For every module of ``src/repro_torch`` that has a counterpart in
``src/repro``, an AST walk collects the public names of both: module-level
functions, classes and constants (and what an ``__init__`` re-exports),
each class's public methods, properties and annotated fields, and the
parameter names of every public function and method.  Every name of the
reference must exist in the port, except those listed in ``EXCEPTIONS``
by name with their reason; an exception whose name has since been ported
fails too, so the list stays exact.  The port may have more names;
those that stand for JAX's own machinery (``DataMesh`` for
``jax.sharding.Mesh``, the ``devices=`` pool for ``jax.devices()``) are
listed in ``DEPARTURES`` with their reasons and held to be the port's only.

The names repaired here (``core`` re-exports, ``ridge_solve``,
``BlockSparse.to_dense``, ``PlanStats.as_dict``, ``RolloutBand.n_cols``,
``BandedRollout.band_data_bytes``, ``tpu_decode_bytes``) are held against
the reference: exactly, and ``ridge_solve`` within float32 tolerance.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


@pytest.fixture(scope="module", autouse=True)
def _release_xla_executables():
    """Free the XLA executables this module's reference calls compiled once
    its tests in this worker are done: each holds JIT memory mappings, and
    a test worker that keeps every module's executables can pass the
    kernel's per-process mapping limit (``vm.max_map_count``) inside a
    later compile, which then aborts the worker (ROADMAP C-port-5)."""
    yield
    jax.clear_caches()


ROOT = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT, REF = ROOT / "repro_torch", ROOT / "repro"

_A12_REPORT = ("A12f: the roofline's report half reads the dry-run "
               "results of launch/dryrun.py, which is not ported yet")
_A12_DRYRUN = ("A12f3: lowering a cell for the dry run and the "
               "EXPERIMENTS.md tables read the dry run's results "
               "(launch/dryrun.py, launch/specs.py), not ported yet")
_A12_SPECS = ("A12f: sharded abstract specs (jax.ShapeDtypeStruct with a "
              "NamedSharding) belong to the dry-run lowering, not ported yet")
_DONATE = ("permanent departure: the helper mutes JAX's buffer-donation "
           "warning for the single-device and sharded dispatch paths; "
           "PyTorch writes the carry in place and has no warning to mute")
_SHIM = ("deprecated shim of the JAX package (boolean twins, serve(), "
         "RolloutRequest submission, warn_deprecated), not ported")
_PALLAS = ("Pallas-only argument: the Pallas kernel's interpret mode, "
           "block shape or operand layout; the CUDA entry takes the device "
           "tables its launch reads")
_RENAME = "renamed: the torch backend's schedule is torch_schedule"


def _params_of(fn: str, *names) -> set:
    return {f"{fn}({n}=)" for n in names}


# module (relative path) -> {missing name: reason}
EXCEPTIONS = {
    "launch/roofline.py": dict.fromkeys(
        ["RESULTS", "cell_report", "cell_report(rec=)", "load_all",
         *_params_of("load_all", "mesh_dir", "variants"), "main",
         "to_markdown", "to_markdown(reports=)"], _A12_REPORT),
    "launch/report.py": dict.fromkeys(
        ["ROOT", "dryrun_table", "roofline_table", "main"], _A12_DRYRUN),
    "launch/steps.py": dict.fromkeys(
        ["lower_cell", *_params_of("lower_cell", "arch_cfg", "donate",
                                   "mesh", "shape")], _A12_DRYRUN),
    "models/quantize.py": dict.fromkeys(
        ["quant_struct_like", "quant_struct_like(struct=)"], _A12_SPECS),
    "dist/engine.py": dict.fromkeys(
        ["ShardedReservoirEngine(interpret=)"], _PALLAS),
    "dist/scheduler.py": dict.fromkeys(
        ["DistributedReservoirServer(return_states=)",
         "ShardedContinuousBatcher(return_states=)"], _SHIM),
    "kernels/bcsr_matmul/bcsr_matmul.py": dict.fromkeys(_params_of(
        "bcsr_matmul", "block", "block_cols", "block_rows", "blocks",
        "interpret", "out_cols"), _PALLAS),
    "kernels/bcsr_matmul/ops.py": dict.fromkeys(
        ["BcsrMatmul(interpret=)"], _PALLAS),
    "kernels/bitplane_gemv/bitplane_gemv.py": dict.fromkeys(
        ["DEFAULT_BLOCK_C", "DEFAULT_BLOCK_R", *_params_of(
            "bitplane_gemv", "block_c", "block_r", "digits", "interpret")],
        _PALLAS),
    "kernels/bitplane_gemv/ops.py": dict.fromkeys(_params_of(
        "BitplaneGemv", "block_c", "block_r", "interpret"), _PALLAS),
    "kernels/reservoir_rollout/ops.py": dict.fromkeys(
        ["FusedRollout(interpret=)"], _PALLAS),
    "kernels/reservoir_rollout/reservoir_rollout.py": dict.fromkeys(
        _params_of("reservoir_rollout", "band_plans", "block", "interpret",
                   "leak", "mode", "readout_every", "recur_scale", "smax",
                   "w_data", "want_final", "want_preds", "want_states"),
        _PALLAS),
    "kernels/reservoir_rollout/specialized.py": dict.fromkeys(
        ["SpecializedRollout(interpret=)", *_params_of(
            "specialized_rollout", "b_tile", "block", "interpret", "leak",
            "mode", "readout_every", "recur_scale", "schedules", "smax",
            "w_data", "want_final", "want_preds", "want_states")], _PALLAS),
    "kernels/reservoir_step/ops.py": dict.fromkeys(_params_of(
        "FusedReservoir", "block", "interpret"), _PALLAS),
    "kernels/reservoir_step/reservoir_step.py": dict.fromkeys(_params_of(
        "reservoir_step", "block_c", "block_r", "interpret"), _PALLAS),
    "serve/api.py": dict.fromkeys(
        ["warn_deprecated", "warn_deprecated(message=)",
         "warn_deprecated(stacklevel=)"], _SHIM),
    "serve/engine.py": {
        **dict.fromkeys(["ReservoirEngine(interpret=)"], _PALLAS),
        **dict.fromkeys(
            [*_params_of("ReservoirEngine.predictions", "defer_sync",
                         "donate_state", "real_steps", "return_final_state"),
             *_params_of("ReservoirEngine.rollout", "defer_sync",
                         "donate_state", "real_steps", "return_final_state"),
             "ReservoirEngine.serve", *_params_of(
                 "ReservoirEngine.serve", "bucketer", "requests",
                 "return_states")], _SHIM),
        "ReservoirEngine.xla_schedule": _RENAME,
        **dict.fromkeys(
            ["donated_call", *_params_of("donated_call", "fn", "u", "x0b")],
            _DONATE),
    },
    "serve/scheduler.py": dict.fromkeys(
        ["AsyncReservoirServer(return_states=)",
         "AsyncReservoirServer.submit(request=)",
         "ContinuousBatcher(return_states=)",
         "ContinuousBatcher.return_states", "QueuedRequest.as_result"],
        _SHIM),
}

# names the port adds where the JAX package uses JAX's own machinery (a
# departure, not a missing name): held to exist in the port only
DEPARTURES = {
    "launch/mesh.py": {
        **dict.fromkeys(
            ["DataMesh", "DataMesh.axis_names", "DataMesh.devices",
             "DataMesh.shape"],
            "for jax.sharding.Mesh: an ordered device tuple with axis "
            "'data' in which a device may repeat, so N shards share one "
            "card (the counterpart of --xla_force_host_platform_"
            "device_count)"),
        **dict.fromkeys(
            ["local_devices", "local_devices(device=)"],
            "for jax.devices(): the visible CUDA devices (raises without "
            "one) or [cpu]"),
        **dict.fromkeys(
            ["LMMesh", "LMMesh.device_mesh", "make_mesh", "AbstractMesh",
             "make_host_mesh(device=)", "make_production_mesh(device=)"],
            "for jax.make_mesh / jax.sharding.Mesh / AbstractMesh: a named "
            "torch DeviceMesh over the process group (one rank per "
            "device), and names and sizes without one"),
    },
    "parallel/sharding.py": dict.fromkeys(
        ["NamedSharding", "placements", "distribute_tree"],
        "for jax.sharding.NamedSharding and jax.device_put: a spec's "
        "DTensor placements, and a tree of full tensors cut into each "
        "rank's shards"),
    "parallel/act.py": dict.fromkeys(
        ["to_local", "from_local"],
        "for shard_map's in_specs / out_specs: the two ends of a local "
        "region, with the gradient's placements declared"),
    "dist/scheduler.py": {
        "DistributedReservoirServer(devices=)":
            "for len(jax.devices()): the ordered device pool the mesh "
            "shrinks and grows within (a prefix of it at every width)",
    },
    "dist/engine.py": dict.fromkeys(
        ["ShardedReservoirEngine.run_segment",
         "ShardedReservoirEngine.run_segment(inputs=)",
         "ShardedReservoirEngine.run_segment(x0=)",
         "ShardedReservoirEngine.run_segment(shards=)"],
        "for shard_map's all-shard program: the batcher names the shards "
        "holding live slots, and an idle shard makes no launch"),
}


def public_names(path: pathlib.Path) -> set:
    """Public names of one module (see the module docstring)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names: set = set()

    def params(fn, owner):
        a = fn.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.arg not in ("self", "cls") and not p.arg.startswith("_"):
                names.add(f"{owner}({p.arg}=)")

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            names.add(node.name)
            if isinstance(node, ast.FunctionDef):
                params(node, node.name)
                continue
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    if sub.name == "__init__":
                        params(sub, node.name)
                    elif not sub.name.startswith("_"):
                        names.add(f"{node.name}.{sub.name}")
                        params(sub, f"{node.name}.{sub.name}")
                elif (isinstance(sub, ast.AnnAssign)
                      and isinstance(sub.target, ast.Name)
                      and not sub.target.id.startswith("_")):
                    names.add(f"{node.name}.{sub.target.id}")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(t.id for t in targets if isinstance(t, ast.Name)
                         and not t.id.startswith("_"))
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names.update(a.asname or a.name for a in node.names)
    return names


MODULES = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                 if (REF / p.relative_to(PORT)).exists())


@pytest.mark.parametrize("module", MODULES)
def test_reference_public_names_exist_in_the_port(module):
    missing = public_names(REF / module) - public_names(PORT / module)
    listed = set(EXCEPTIONS.get(module, {}))
    assert missing - listed == set(), "names missing from the port"
    assert listed - missing == set(), "listed exceptions now ported"


def test_every_exception_names_a_ported_module():
    assert set(EXCEPTIONS) <= set(MODULES)
    assert all(reason for ex in EXCEPTIONS.values() for reason in ex.values())


@pytest.mark.parametrize("module", sorted(DEPARTURES))
def test_departures_exist_in_the_port_only(module):
    listed = set(DEPARTURES[module])
    assert all(DEPARTURES[module].values())
    assert listed <= public_names(PORT / module)
    assert not listed & public_names(REF / module)


def test_walk_sees_methods_fields_and_parameters(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text(
        "X = 1\n_Y = 2\n"
        "def f(a, *, b=0, _c=1):\n    pass\n"
        "class K:\n    n: int\n    def __init__(self, d):\n        pass\n"
        "    def g(self, e):\n        pass\n"
        "    @property\n    def h(self):\n        return 0\n"
        "    def _i(self):\n        pass\n")
    assert public_names(mod) == {"X", "f", "f(a=)", "f(b=)", "K", "K.n",
                                 "K(d=)", "K.g", "K.g(e=)", "K.h"}


def test_serve_all_equals_reference():
    import repro.serve
    import repro_torch.serve
    assert repro_torch.serve.__all__ == repro.serve.__all__
    assert len(repro_torch.serve.__all__) == 24
    for name in repro_torch.serve.__all__:
        assert hasattr(repro_torch.serve, name), name


def test_core_reexports_like_reference():
    import repro.core
    import repro_torch.core
    from repro_torch.core import (BlockSparse, DigitPlanes,  # noqa: F401
                                  ESNConfig, FixedMatrix, convert_to_csd,
                                  csd_transform, decompose, design_point,
                                  expected_ones, init_esn, pn_split,
                                  run_reservoir)
    want = {n for n in dir(repro.core) if not n.startswith("_")
            and not isinstance(getattr(repro.core, n), type(repro))}
    assert want <= set(dir(repro_torch.core))


# -- parity of the repaired names ---------------------------------------------
def _fixed(seed=0, dim=96, block=32, es=0.9):
    from repro.core.sparse import FixedMatrix as JFixed
    from repro.core.sparse import random_sparse_matrix
    from repro_torch.core.bitplanes import DigitPlanes
    from repro_torch.core.sparse import FixedMatrix as TFixed
    rng = np.random.default_rng(seed)
    dense = random_sparse_matrix(dim, dim, es, rng) * 0.1
    dense[:, block:2 * block] = 0.0                 # a culled column block
    ref = JFixed.compile(dense, weight_bits=8, mode="csd", block=block,
                         rng=rng)
    planes = DigitPlanes(pos=ref.planes.pos, neg=ref.planes.neg,
                         mode="csd", source_bits=8)
    port = TFixed.from_parts(np.asarray(ref.q), ref.scale, planes, block)
    return ref, port


@pytest.mark.parametrize("dim,block", [(96, 32), (100, 32), (128, 64)])
def test_block_sparse_to_dense_matches_reference(dim, block):
    ref, port = _fixed(dim=dim, block=block)
    got, want = port.blocks.to_dense(), np.asarray(ref.blocks.to_dense())
    assert got.shape == want.shape == (dim, dim) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("budget", [None, 24 * 1024, 48 * 1024])
@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_plan_stats_and_bands_match_reference(mode, budget):
    from repro.plan import plan_for as j_plan_for
    from repro_torch.plan import plan_for
    ref, port = _fixed(seed=3)
    jp, tp = j_plan_for(ref), plan_for(port)
    assert tp.stats.as_dict() == jp.stats.as_dict()
    jl = jp.rollout_layout(mode, vmem_budget=budget)
    tl = tp.rollout_layout(mode, vmem_budget=budget)
    assert tl.band_data_bytes == jl.band_data_bytes > 0
    assert [b.n_cols for b in tl.bands] == [b.n_cols for b in jl.bands]
    assert sum(b.n_cols for b in tl.bands) == tp.nbc
    assert tl.n_bands == jl.n_bands


@pytest.mark.parametrize("mode", ["csd", "pn"])
@pytest.mark.parametrize("es", [0.5, 0.9, 0.99])
def test_tpu_decode_bytes_matches_reference(es, mode):
    from repro.core.costmodel import tpu_decode_bytes as j_bytes
    from repro_torch.core.costmodel import tpu_decode_bytes
    assert tpu_decode_bytes(1024, 800, es, mode=mode) == \
        j_bytes(1024, 800, es, mode=mode)


@pytest.mark.parametrize("lam", [1e-6, 1e-2, 1.0])
def test_ridge_solve_matches_reference(lam):
    from repro.core.ridge import ridge_solve as j_solve
    from repro_torch.core.ridge import gram_accumulate, ridge_solve
    rng = np.random.default_rng(4)
    base = rng.standard_normal((400, 8))
    # strongly correlated states: a near-singular Gram
    x = np.concatenate([base, base @ rng.standard_normal((8, 24)) * 1e-3
                        + base[:, :1]], axis=1).astype(np.float32)
    y = rng.standard_normal((400, 2)).astype(np.float32)
    xtx, xty = gram_accumulate(torch.as_tensor(x), torch.as_tensor(y))
    got = ridge_solve(xtx, xty, lam)
    want = np.asarray(j_solve(jnp.asarray(xtx.numpy()),
                              jnp.asarray(xty.numpy()), lam))
    assert torch.isfinite(got).all()
    # compare the fitted values: the float32 eigensolvers of the two
    # frameworks split the near-null space differently, the fit does not
    np.testing.assert_allclose(x @ got.numpy(), x @ want, atol=2e-3)
    if lam >= 1.0:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
