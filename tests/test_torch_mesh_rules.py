"""The port's sharding rules against the JAX package's, entry for entry.

Pure functions, in process (no process group): ``resolve_axes``,
``param_shardings``, ``batch_spec``, ``batch_sharding``, ``cache_sharding``
and the cache-leaf policy on the reference's ``AbstractMesh(axis_sizes,
axis_names)`` and the port's ``AbstractMesh``.  The cases of the
reference's ``tests/test_parallel.py:21-60`` (which never run here,
ROADMAP C-ref-2), then every registered config's full-width parameter
tree (the reference's ``jax.eval_shape`` of ``LM.init``, the port's
``meta`` init) on 16x16, 2x16x16, 2x2 and 1x1 with ``use_tp`` and
``expert_fsdp`` both ways.  Everything is exact.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh as JMesh, PartitionSpec as P

import repro.configs as jcfg
from repro.launch.specs import _cache_leaf_sharding
from repro.models.transformer import LM as JLM
from repro.parallel import sharding as jsh

import repro_torch.configs as tcfg
from repro_torch.launch.mesh import (AbstractMesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.transformer import LM, cache_spec, lm_param_shardings
from repro_torch.parallel import sharding as tsh


@pytest.fixture(scope="module", autouse=True)
def _release_xla_executables():
    """Free the XLA executables this module's reference calls compiled once
    its tests in this worker are done: each holds JIT memory mappings, and
    a test worker that keeps every module's executables can pass the
    kernel's per-process mapping limit (``vm.max_map_count``) inside a
    later compile, which then aborts the worker (ROADMAP C-port-5)."""
    yield
    jax.clear_caches()


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
ARCHS = jcfg.list_archs()


def meshes(key):
    sizes, names = MESHES[key]
    return JMesh(sizes, names), AbstractMesh(sizes, names)


def spec(p) -> tuple:
    """A reference ``PartitionSpec`` as the port's tuple."""
    return tuple(p)


# --- tests/test_parallel.py:21-60, on both packages --------------------
@pytest.mark.parametrize("logical,shape,mesh,want", [
    (("embed", "ffn"), (5120, 25600), "16x16", P("data", "model")),
    (("embed", "kv", None), (2048, 1, 256), "16x16", P("data", None, None)),
    (("embed", "heads", None), (5120, 64, 128), "16x16",
     P("data", "model", None)),
    (("embed", "ffn"), (5120, 25600), "2x16x16",
     P(("pod", "data"), "model")),
    (("embed",), (100,), "16x16", P(None)),
    (("vocab", "heads"), (512, 64), "16x16", P("model", None)),
    (("layers", "embed", "ffn"), (64, 5120, 1024), "16x16",
     P(None, "data", "model")),
])
def test_logical_rules_like_test_parallel(logical, shape, mesh, want):
    jm, tm = meshes(mesh)
    assert jsh.resolve_axes(logical, shape, jm) == want
    assert tsh.resolve_axes(logical, shape, tm) == spec(want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_spec_and_data_axes(mesh):
    jm, tm = meshes(mesh)
    assert tsh.batch_spec(tm) == spec(jsh.batch_spec(jm))
    assert tsh.data_axis_names(tm) == jsh.data_axis_names(jm)
    assert tsh.data_axis_size(tm) == jsh.data_axis_size(jm)
    for ndim in (1, 2, 3):
        assert tsh.batch_sharding(tm, ndim).spec == spec(
            jsh.batch_sharding(jm, ndim).spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape,kw", [
    ((8, 128, 8, 64), dict(n_kv=8, kv_dim=2, seq_dim=1)),
    ((8, 128, 1, 64), dict(n_kv=1, kv_dim=2, seq_dim=1)),
    ((1, 128, 2, 64), dict(n_kv=2, kv_dim=2, seq_dim=1)),
    ((32, 100, 1, 64), dict(n_kv=1, kv_dim=2, seq_dim=1)),
    ((64, 4096, 512), dict(seq_dim=1)),
    ((16, 2560), dict(n_kv=2560, kv_dim=1)),
    ((16, 4096), {}),
])
def test_cache_sharding(mesh, shape, kw):
    jm, tm = meshes(mesh)
    assert tsh.cache_sharding(tm, shape, **kw).spec == spec(
        jsh.cache_sharding(jm, shape, **kw).spec)


# --- every config's full-width parameter tree ------------------------------
_REF_TREES: dict = {}


def _ref_tree(arch):
    if arch not in _REF_TREES:
        _REF_TREES[arch] = jax.eval_shape(
            JLM(jcfg.get_config(arch)).init, jax.random.PRNGKey(0))
    return _REF_TREES[arch]


def _flat_specs(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flat_specs(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("expert_fsdp", [True, False])
@pytest.mark.parametrize("use_tp", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_equal_reference(arch, mesh, use_tp, expert_fsdp):
    jm, tm = meshes(mesh)
    ref = _ref_tree(arch)
    want = jsh.param_shardings(ref.axes, ref.params, jm, use_tp=use_tp,
                               expert_fsdp=expert_fsdp)
    cfg = tcfg.get_config(arch).replace(use_tp=use_tp)
    got = lm_param_shardings(cfg, tm, fsdp=True, expert_fsdp=expert_fsdp)
    want, got = _flat_specs(want), _flat_specs(got)
    assert set(got) == set(want)
    for name in want:
        assert got[name].spec == spec(want[name].spec), name
        assert got[name].mesh is tm


@pytest.mark.parametrize("mesh", ["16x16", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_placements_equal_reference(arch, mesh):
    """The cache-leaf policy (the reference's ``launch/specs.py``) on
    every config's caches of batch 16 and length 256."""
    jm, tm = meshes(mesh)
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    caches = jax.eval_shape(lambda: JLM(jc).init_caches(16, 256))
    want = {}

    def leaf(path, sds):
        names = tuple(getattr(p, "key", getattr(p, "name", "")) for p in path)
        want[names] = spec(_cache_leaf_sharding(path, sds, jc, jm,
                                                jc.scan_layers).spec)

    jax.tree_util.tree_map_with_path(leaf, caches)
    meta = LM(tc, device="meta").init_caches(16, 256)
    got = {}
    for key in ("groups", "tail"):
        for name, t in _flat_specs(meta[key] or {}, f"{key}.").items():
            path = tuple(name.split("."))
            got[path] = cache_spec(path, tuple(t.shape), tc, tm)
    assert got and set(got) == set(k for k in want if k[0] != "index")
    for path, s in got.items():
        assert s == want[path], path


# --- placements and meshes ---------------------------------------------------
def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    _, tm = meshes("2x16x16")
    assert tsh.placements((("pod", "data"), "model"), tm) == (
        Shard(0), Shard(0), Shard(1))
    assert tsh.placements((None, "data"), tm) == (
        Replicate(), Shard(1), Replicate())
    assert tsh.placements((), tm) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements((("data", "pod"),), tm)
    with pytest.raises(ValueError, match="twice"):
        tsh.placements(("model", "model"), tm)
    assert tsh.NamedSharding(tm, ("model",)).placements == (
        Replicate(), Replicate(), Shard(0))
    # a mesh dim of size 1 holds the whole dim: replicated
    one = AbstractMesh((1, 2), ("data", "model"))
    assert tsh.placements(("data", "model"), one) == (Replicate(), Shard(1))


def test_abstract_mesh_has_names_and_sizes():
    m = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.axis_names == ("pod", "data", "model")
    with pytest.raises(ValueError):
        AbstractMesh((2, 2), ("data",))


def test_production_and_host_meshes_need_their_ranks():
    """No process group here: the production mesh raises (it needs 256 or
    512 ranks), and the host mesh's default device is the card."""
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(multi_pod=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()


def test_one_rank_cpu_world_builds_the_host_mesh(tmp_path):
    """A world of one (gloo, a file store): ``make_host_mesh(device="cpu")``
    is (1, 1); the production mesh names the ranks it lacks."""
    import torch.distributed as dist

    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = make_host_mesh(device="cpu")
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.coordinate() == {"data": 0, "model": 0}
        assert mesh.device == torch.device("cpu")
        with pytest.raises(ValueError, match="256 ranks"):
            make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("hq,hkv,n,want", [
    (32, 8, 16, [slice(r // 2, r // 2 + 1) for r in range(16)]),
    (64, 8, 4, [slice(2 * r, 2 * r + 2) for r in range(4)]),
    (4, 1, 2, [slice(0, 1), slice(0, 1)]),
    (12, 4, 4, [slice(r, r + 1) for r in range(4)]),
    (12, 3, 4, [None] * 4),
])
def test_kv_heads_each_rank_attends_to(hq, hkv, n, want):
    """With query heads split over 'model' and kv heads that do not
    divide, each rank takes the kv heads of its query heads' groups (or
    none fit: the heads stay replicated)."""
    from repro_torch.models.attention import _kv_slice
    assert [_kv_slice(hq, hkv, n, r) for r in range(n)] == want
