"""``launch/specs.py`` and ``quant_struct_like`` against the JAX package's.

Every registered config at full width, every shape, on the production
meshes as ``AbstractMesh`` (16 x 16 and 2 x 16 x 16: names and sizes, no
devices): each struct's shape, dtype and spec equal the reference's, leaf
by leaf (a spec compared as a tuple padded with ``None`` to the leaf's
rank, as ``PartitionSpec`` and the port's tuples both read).  The one
departure: token ids are int64 in the port (``specs.TOKEN_DTYPE``, the
dtype the port's embedding lookup and cross entropy index with), int32 in
the reference; their bytes differ by that factor and nothing else.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh as JAbstractMesh

import repro.configs as jcfg
import repro_torch.configs as tcfg
from repro.launch import specs as jspecs
from repro.models import quantize as jquant
from repro.models.transformer import LM as JLM
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import quantize as tquant
from repro_torch.models.common import tree_leaves_with_path
from repro_torch.models.transformer import LM
from repro_torch.parallel.sharding import ShapeDtypeStruct


@pytest.fixture(scope="module", autouse=True)
def _release_xla_executables():
    """Free the XLA executables this module compiled (ROADMAP C-port-5)."""
    yield
    jax.clear_caches()


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = jcfg.list_archs()


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _spec(spec, ndim) -> tuple:
    spec = tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in (spec or ()))
    return spec + (None,) * (ndim - len(spec))


def ref_flat(tree) -> dict:
    """{path: (shape, dtype, spec)} of a reference struct tree."""
    out = {}
    for path, sds in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(p, "key", getattr(p, "name", None))
                    for p in path)
        spec = None if sds.sharding is None else sds.sharding.spec
        out[key] = (tuple(sds.shape), _dtype_name(jnp.dtype(sds.dtype)),
                    _spec(spec, len(sds.shape)))
    return out


def port_flat(tree) -> dict:
    out = {}
    for path, sds in tree_leaves_with_path(tree):
        assert isinstance(sds, ShapeDtypeStruct)
        spec = None if sds.sharding is None else sds.sharding.spec
        out[tuple(path)] = (sds.shape, _dtype_name(sds.dtype),
                            _spec(spec, len(sds.shape)))
    return out


def _tokens_int64(flat: dict) -> dict:
    """The reference's flattened structs with token ids as the port's."""
    return {k: (s, "int64" if k[-1:] in (("tokens",), ()) and d == "int32"
                else d, sp) for k, (s, d, sp) in flat.items()}


def meshes(name):
    sizes, names = MESHES[name]
    return JAbstractMesh(sizes, names), AbstractMesh(sizes, names)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch, mesh_name):
    jm, tm = meshes(mesh_name)
    jlm, tlm = JLM(jcfg.get_config(arch)), LM(tcfg.get_config(arch),
                                              device="meta")
    for fsdp, ef in ((True, None), (False, None), (True, True)):
        js, _ = jspecs.params_specs(jlm, jm, fsdp=fsdp, expert_fsdp=ef)
        ts, _ = tspecs.params_specs(tlm, tm, fsdp=fsdp, expert_fsdp=ef)
        assert port_flat(ts) == ref_flat(js), (fsdp, ef)
        for dt in ("float32", "bfloat16"):
            assert port_flat(tspecs.opt_state_specs(ts, tm, dt)) == ref_flat(
                jspecs.opt_state_specs(js, jm, dt))
        # int8 structs: equal, and the same leaves quantized
        assert port_flat(tquant.quant_struct_like(ts)) == ref_flat(
            jquant.quant_struct_like(js))
    for name, jshape in jcfg.SHAPES.items():
        tshape = tcfg.SHAPES[name]
        got = port_flat(tspecs.batch_specs(tlm.cfg, tshape, tm))
        want = ref_flat(jspecs.batch_specs(jlm.cfg, jshape, jm))
        assert got == {(k[0],): v for k, v in _tokens_int64(
            {k: v for k, v in want.items()}).items()}, name
        tok = port_flat({"t": tspecs.token_spec(tshape, tm)})
        want = ref_flat({"t": jspecs.token_spec(jshape, jm)})
        assert tok == {k: (s, "int64", sp) for k, (s, d, sp) in
                       want.items()}
        assert want[("t",)][1] == "int32"
        if jshape.kind == "decode":
            got = port_flat(tspecs.cache_specs(tlm, tshape, tm))
            want = ref_flat(jspecs.cache_specs(jlm, jshape, jm))
            assert got == want, name


def test_token_ids_are_the_one_dtype_departure():
    assert tspecs.TOKEN_DTYPE == torch.int64
    assert tspecs.N_PATCHES == jspecs.N_PATCHES == 256


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "olmoe-1b-7b",
                                  "xlstm-350m", "deepseek-v2-236b",
                                  "whisper-base"])
def test_quant_struct_like_matches_quantize_tree(arch, monkeypatch):
    """The int8 structs of a reduced config have the shapes and dtypes of
    ``quantize_tree``'s leaves on real weights (and the reference's).  A
    reduced config's leaves are under ``MIN_QUANT_SIZE``: both packages'
    threshold is lowered to 256 elements here, so the stacked (>= 3D)
    leaves quantize (a 2D leaf still needs both dims >= 1024)."""
    monkeypatch.setattr(tquant, "MIN_QUANT_SIZE", 256)
    monkeypatch.setattr(jquant, "MIN_QUANT_SIZE", 256)
    cfg = tcfg.reduced(tcfg.get_config(arch))
    mesh = AbstractMesh((2, 2), ("data", "model"))
    structs, _ = tspecs.params_specs(LM(cfg, device="meta"), mesh)
    q = tquant.quant_struct_like(structs)
    lm = LM(cfg, device="cpu")
    real = tquant.quantize_tree(lm.init(torch.Generator().manual_seed(0))
                                .params)
    got = {p: (s.shape, s.dtype) for p, s in tree_leaves_with_path(q)}
    want = {p: (tuple(t.shape), t.dtype)
            for p, t in tree_leaves_with_path(real)}
    assert got == want
    n_int8 = sum(d == torch.int8 for _, d in got.values())
    assert n_int8 > 0
    jq = jquant.quant_struct_like(jspecs.params_specs(
        JLM(jcfg.reduced(jcfg.get_config(arch))),
        JAbstractMesh((2, 2), ("data", "model")))[0])
    assert port_flat(q) == ref_flat(jq)


def test_quant_struct_like_keeps_unsharded_structs():
    s = ShapeDtypeStruct((4, 1024, 2048), torch.bfloat16)
    q = tquant.quant_struct_like({"w": s, "b": ShapeDtypeStruct(
        (2048,), torch.float32)})
    assert q["w"]["q"] == ShapeDtypeStruct((4, 1024, 2048), torch.int8)
    assert q["w"]["scale"] == ShapeDtypeStruct((4, 2048), torch.float32)
    assert q["b"] == ShapeDtypeStruct((2048,), torch.float32)
    js = jax.ShapeDtypeStruct((4, 1024, 2048), jnp.bfloat16)
    jq = jquant.quant_struct_like({"w": js})
    assert jq["w"]["scale"].shape == (4, 2048)
    assert np.dtype(jq["w"]["q"].dtype) == np.int8
