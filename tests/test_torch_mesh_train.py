"""Training on a 2x2 device mesh against the JAX package's (CPU).

Two ``make_train_step`` steps from the same state, the reference's jitted
builder on 4 host devices of a ``Mesh(np.array(devices).reshape(2, 2),
("data", "model"))``, the port's in a gloo world of 4 spawned ranks
(``_mesh_cases.py``, run once per test run side by side within a time
limit of their own): stablelm, xlstm (its sLSTM under
``_slstm_sharded``) and olmoe (2 microbatches, EP-resident experts,
``expert_fsdp=False``, and the ZeRO ``grad_shardings`` the reference's
``lower_cell`` passes).  Loss, grad norm and every new parameter.  And
stablelm's two steps on a 2x2x2 ``("pod", "data", "model")`` mesh (8
host devices, 8 ranks; in the port 'pod' and 'data' are one DTensor mesh
dim of 4), within the same tolerances.

AdamW runs at ``eps`` 1e-3 (``_mesh_cases.STEP_CFG``): at the default 1e-8
a first update is ``lr * sign(g)``, so a gradient within float32 noise of
0 moves its weight by up to ``2 lr`` in either package, whatever the mesh.
Tolerances (float32): ``FWD_TOL`` 1e-5 relative for the loss and grad
norm; ``ADAM_TOL`` 1e-4 absolute on parameters after the two steps.
"""

import numpy as np
import pytest

import _mesh_cases as mc

FWD_TOL = 1e-5
ADAM_TOL = 1e-4
TIMEOUT = 600.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mc.shared_run(tmp_path_factory, "mesh_train", ("train",),
                         TIMEOUT)


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


@pytest.mark.parametrize("what", ["loss0", "loss1", "grad_norm0",
                                  "grad_norm1"])
@pytest.mark.parametrize("arch", sorted(mc.TRAIN_CASES))
def test_train_metrics_on_the_mesh_match_reference(runs, arch, what):
    _, ref, port = runs
    assert rel(port[f"train|{arch}|{what}"], ref[f"train|{arch}|{what}"]) \
        <= FWD_TOL


@pytest.mark.parametrize("arch", sorted(mc.TRAIN_CASES))
def test_train_parameters_on_the_mesh_match_reference(runs, arch):
    _, ref, port = runs
    want = mc.sub(ref, f"train|{arch}|params")
    got = mc.sub(port, f"train|{arch}|params")
    assert set(got) == set(want) and want
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=ADAM_TOL, err_msg=name)


@pytest.mark.parametrize("what", ["loss0", "loss1", "grad_norm0",
                                  "grad_norm1"])
@pytest.mark.parametrize("arch", mc.TRAIN_222_ARCHS)
def test_train_metrics_on_the_3d_mesh_match_reference(runs, arch, what):
    _, ref, port = runs
    assert rel(port[f"train222|{arch}|{what}"],
               ref[f"train222|{arch}|{what}"]) <= FWD_TOL


@pytest.mark.parametrize("arch", mc.TRAIN_222_ARCHS)
def test_train_parameters_on_the_3d_mesh_match_reference(runs, arch):
    _, ref, port = runs
    want = mc.sub(ref, f"train222|{arch}|params")
    got = mc.sub(port, f"train222|{arch}|params")
    assert set(got) == set(want) and want
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=ADAM_TOL, err_msg=name)
