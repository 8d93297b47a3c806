"""The port's LM configs and the roofline's LM half against the JAX package.

Every registered architecture equal field by field (nested sub-configs
included), ``reduced()``, ``list_archs()``, ``SHAPES`` and the
``supports_shape`` matrix equal; the full-width parameter count of every
architecture equal to the reference's ``LM.param_count()`` (the port's
counted on the ``meta`` device); only a device mesh still raises
``NotImplementedError`` naming its ROADMAP item (A12f); the roofline's LM
functions equal for every arch x shape (the same Python arithmetic, so
exactly), at the H100's peaks.
"""

import dataclasses

import pytest
import torch

import jax

import repro.configs as jcfg
import repro.launch.roofline as jroof
import repro_torch.configs as tcfg
import repro_torch.launch.roofline as troof
from repro.models.transformer import LM as JLM
from repro_torch.models.transformer import LM


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


ARCHS = jcfg.list_archs()
DENSE = ["gemma-2b", "internvl2-76b", "mistral-nemo-12b", "qwen3-32b",
         "stablelm-1.6b"]
# the archs of the later A12 slices: MoE and MLA (A12b), the recurrent
# blocks (A12c), the enc-dec stack (A12d)
LATER = ["deepseek-v2-236b", "olmoe-1b-7b", "recurrentgemma-2b",
         "whisper-base", "xlstm-350m"]


def test_archs_listed_alike():
    assert tcfg.list_archs() == ARCHS
    assert sorted(DENSE + LATER) == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equal_field_by_field(arch):
    ref, port = jcfg.get_config(arch), tcfg.get_config(arch)
    assert ([f.name for f in dataclasses.fields(port)]
            == [f.name for f in dataclasses.fields(ref)])
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.n_groups, port.tail_pattern) == (ref.n_groups,
                                                  ref.tail_pattern)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_equal(arch):
    ref = jcfg.reduced(jcfg.get_config(arch))
    port = tcfg.reduced(tcfg.get_config(arch))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.n_groups, port.tail_pattern) == (ref.n_groups,
                                                  ref.tail_pattern)


def test_replace_and_sub_configs_equal():
    base = tcfg.get_config("mistral-nemo-12b")
    assert base.replace(window=8).window == 8 and base.window is None
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    for name in ("MoEConfig", "MLAConfig", "EncoderConfig"):
        jc, tc = getattr(jbase, name), getattr(tbase, name)
        assert ([(f.name, f.default) for f in dataclasses.fields(tc)]
                == [(f.name, f.default) for f in dataclasses.fields(jc)])


def test_shapes_equal():
    assert list(tcfg.SHAPES) == list(jcfg.SHAPES)
    for name, shape in jcfg.SHAPES.items():
        assert dataclasses.asdict(tcfg.SHAPES[name]) == \
            dataclasses.asdict(shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_supports_shape_matrix_equal(arch):
    for name in jcfg.SHAPES:
        assert tcfg.supports_shape(tcfg.get_config(arch),
                                   tcfg.SHAPES[name]) == \
            jcfg.supports_shape(jcfg.get_config(arch), jcfg.SHAPES[name])


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_count_equal(arch):
    port = LM(tcfg.get_config(arch), device="cpu").param_count()
    assert port == JLM(jcfg.get_config(arch)).param_count()


def test_mistral_nemo_param_count_constant():
    # the constant chip_smoke.py holds the full-width model to
    assert LM(tcfg.get_config("mistral-nemo-12b"),
              device="cpu").param_count() == 12_247_782_400


@pytest.mark.parametrize("arch,count", [
    ("olmoe-1b-7b", 6_919_100_416),
    ("deepseek-v2-236b", 239_375_569_920)])
def test_moe_param_count_constants(arch, count):
    # the constants chip_smoke.py's lm_blocks phase holds the models to
    assert LM(tcfg.get_config(arch), device="cpu").param_count() == count


def test_deepseek_depth_cut_param_count_constant():
    cut = tcfg.get_config("deepseek-v2-236b").replace(n_layers=4)
    assert LM(cut, device="cpu").param_count() == 16_937_047_040
    assert JLM(jcfg.get_config("deepseek-v2-236b").replace(
        n_layers=4)).param_count() == 16_937_047_040


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_builds_and_only_a_mesh_raises(arch):
    """Every arch runs on a mesh (``test_torch_mesh_lm.py``) but for int8
    frozen-weight leaves, which wait for ROADMAP A12f3."""
    from repro_torch.models.transformer import ParallelCtx
    cfg = tcfg.reduced(tcfg.get_config(arch))
    lm = LM(cfg, device="cpu")
    params = {"embed": {"q": torch.zeros((2, 2), dtype=torch.int8),
                        "scale": torch.ones(2)}}
    with pytest.raises(NotImplementedError, match="A12f3"):
        lm.prefill(params, {"tokens": torch.zeros((1, 2), dtype=torch.long)},
                   cache_len=4, ctx=ParallelCtx(mesh=object()))


def test_lm_defaults_to_the_card():
    cfg = tcfg.reduced(tcfg.get_config("qwen3-32b"))
    if torch.cuda.is_available():
        assert LM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LM(cfg)


@pytest.mark.parametrize("shape", list(jcfg.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_lm_functions_equal(arch, shape):
    rc, pc = jcfg.get_config(arch), tcfg.get_config(arch)
    rs, ps = jcfg.SHAPES[shape], tcfg.SHAPES[shape]
    total = 12_247_782_400
    assert troof.expert_params_per_layer(pc) == \
        jroof.expert_params_per_layer(rc)
    n_act = troof.active_params(pc, total)
    assert n_act == jroof.active_params(rc, total)
    assert troof.model_flops(pc, ps, n_act) == jroof.model_flops(rc, rs,
                                                                 n_act)
    assert troof.kv_cache_bytes(pc, ps) == jroof.kv_cache_bytes(rc, rs)
    for n_dev, wbytes in ((1, 2.0), (256, 2.0), (1, 1.0)):
        assert troof.analytic_hbm_bytes(pc, ps, total, n_act, n_dev, wbytes) \
            == jroof.analytic_hbm_bytes(rc, rs, total, n_act, n_dev, wbytes)


def test_roofline_peaks_are_the_h100s():
    assert troof.PEAK_FLOPS == 989e12       # bf16 dense, SXM data sheet
    assert troof.HBM_BW == 3.35e12
    assert troof.LINK_BW == 450e9           # NVLink 4, per direction
