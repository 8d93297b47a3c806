"""LM serving on a 2x2 device mesh against the JAX package's (CPU).

The reference runs its step builders on 4 host devices of a
``Mesh(np.array(devices).reshape(2, 2), ("data", "model"))`` (jax 0.9's
``make_mesh`` makes Explicit axes, on which its train step fails: ROADMAP
C-ref-8, pinned below); the port runs the same builders in a gloo world
of 4 spawned ranks on an ``LMMesh``.  Both take the same parameters
(placed by ``param_shardings``) and inputs (``_mesh_cases.py``), run once
per test run side by side within a time limit of their own.

Five registered configs at ``reduced()`` size in float32 (MHA, GQA, MoE,
the xLSTM blocks, MLA; ``_mesh_cases.SERVE_ARCHS``): the prefill's last
logits and four teacher-forced decode steps' logits (mistral-nemo's one
kv head holds its cache's sequence over 'model', so its decode reduces
the softmax across ranks; deepseek's latent cache likewise).  The MoE
arch's prefill and decode steps also on a 2x2x2 ``("pod", "data",
"model")`` mesh (8 host devices, 8 ranks; in the port 'pod' and 'data'
are one DTensor mesh dim of 4, and its experts run expert-parallel).  ``FWD_TOL`` 1e-5 relative to the largest logit (the
reference's own mesh-vs-none gap is ~1.7e-6).

Int8 frozen-weight serving on the same 2x2 (``_mesh_cases.INT8_ARCHS``:
GQA with a sequence-split cache, and the MoE): the serve part's
parameters quantized by each package's ``quantize_tree`` (bit for bit the
same leaves), placed as ``lower_cell`` places them (``q`` as its weight,
``scale`` by the weight's out-channel dim), prefill and four decode steps
within the same ``FWD_TOL``.
"""

import numpy as np
import pytest

import _mesh_cases as mc

FWD_TOL = 1e-5
TIMEOUT = 600.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mc.shared_run(tmp_path_factory, "mesh_serve", ("serve", "int8"),
                         TIMEOUT)


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


@pytest.mark.parametrize("step", ["prefill"] + [
    f"decode{i}" for i in range(mc.DECODE_STEPS)])
@pytest.mark.parametrize("arch", mc.SERVE_ARCHS)
def test_serving_on_the_mesh_matches_reference(runs, arch, step):
    _, ref, port = runs
    want = ref[f"serve|{arch}|{step}"]
    got = port[f"serve|{arch}|{step}"]
    assert got.shape == want.shape
    assert rel(got, want) <= FWD_TOL


@pytest.mark.parametrize("step", ["prefill"] + [
    f"decode{i}" for i in range(mc.DECODE_STEPS)])
@pytest.mark.parametrize("arch", mc.INT8_ARCHS)
def test_int8_serving_on_the_mesh_matches_reference(runs, arch, step):
    _, ref, port = runs
    want = ref[f"int8|{arch}|{step}"]
    got = port[f"int8|{arch}|{step}"]
    assert got.shape == want.shape
    assert rel(got, want) <= FWD_TOL


@pytest.mark.parametrize("step", ["prefill"] + [
    f"decode{i}" for i in range(mc.DECODE_STEPS)])
@pytest.mark.parametrize("arch", mc.SERVE_222_ARCHS)
def test_serving_on_the_3d_mesh_matches_reference(runs, arch, step):
    _, ref, port = runs
    want = ref[f"serve222|{arch}|{step}"]
    got = port[f"serve222|{arch}|{step}"]
    assert got.shape == want.shape
    assert rel(got, want) <= FWD_TOL


def test_reference_train_step_fails_on_make_host_mesh(runs):
    """C-ref-8: jax 0.9's ``jax.make_mesh`` (the reference's
    ``make_host_mesh``) makes Explicit axes, and the reference's train step
    on it fails at the microbatch reshape."""
    _, ref, _ = runs
    assert str(ref["cref8|error"]).startswith("ShardingTypeError"), \
        str(ref["cref8|error"])
