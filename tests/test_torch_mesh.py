"""The port on a device mesh against the JAX package's mesh runs (CPU).

The reference runs on 8 host devices, the port in a gloo world of 8
spawned ranks (``_mesh_world.py``), each on the same seeded inputs
(``_mesh_cases.py``); both run once per test run, side by side, within a
time limit of their own, and the cases below compare their files.

- Placements: every rank's ``to_local()`` shard of every parameter equals
  the reference's addressable shard on the device with the same mesh
  coordinates, bit for bit, on the 2x2 and the 2x2x2 (pod, data, model).
- The MoE's expert-parallel branch on the 2x2 at a capacity that drops
  assignments (capacity factor 1.0, per-shard capacity
  ``max(ceil(t_local k cf / E), 4)``), forward and gradients, held against
  the reference's mesh run (not ``mesh=None``, from which it differs).
- ``_slstm_sharded`` and its gradients (the recurrent weights' summed over
  the data shards once per call).
- ``compressed_psum`` over 'model': the error bit for bit, the total to
  float32 summation order.
- ``restore(shardings=)``: a state written under the 2x2 and read under
  the 4x1 gives each rank the stored arrays' slice at its coordinate, bit
  for bit.

Tolerances (float32): ``FWD_TOL`` 1e-5 relative to each output's largest
entry (the reference's own mesh-vs-none difference is ~1.7e-6); ``GRAD_TOL``
1e-4 relative to each gradient's largest entry, as the train tests hold
gradients (the combine sums in rank order, XLA in another).
"""

import numpy as np
import pytest

import _mesh_cases as mc

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
TIMEOUT = 600.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mc.shared_run(tmp_path_factory, "mesh_blocks", ("blocks",),
                         TIMEOUT)


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


def _shard_keys():
    """(arch, mesh, leaf) for every placement case, from the inputs the
    cases write (the parameter names of each reduced config)."""
    import torch  # noqa: F401  (the port's initializer names the leaves)
    import repro_torch.configs as tcfg
    from repro_torch.models.transformer import LM

    out = []
    for arch in mc.PLACE_ARCHS:
        lm = LM(mc.cfg_of(tcfg, arch), device="meta")
        names = mc.flatten(lm._init(torch.Generator(),
                                    torch.device("meta")).params)
        out += [(arch, key, name) for key in ("22", "222") for name in names]
    return out


@pytest.mark.parametrize("arch,mesh,leaf", _shard_keys())
def test_every_rank_holds_the_reference_shard(runs, arch, mesh, leaf):
    _, ref, port = runs
    n = int(np.prod(mc.MESHES[mesh][0]))
    want = mc.sub(ref, f"shard|{arch}|{mesh}|{leaf}")
    got = mc.sub(port, f"shard|{arch}|{mesh}|{leaf}")
    assert len(want) == n and set(got) == set(want)
    for c in want:
        assert got[c].shape == want[c].shape, c
        np.testing.assert_array_equal(got[c], want[c])


def test_moe_capacity_drops_differ_from_no_mesh(runs):
    _, ref, _ = runs
    assert rel(ref["moe|y"], ref["moe|y_nomesh"]) > 1e-3


@pytest.mark.parametrize("what", ["y", "aux", "gx"])
def test_moe_expert_parallel_matches_reference_mesh(runs, what):
    _, ref, port = runs
    tol = FWD_TOL if what in ("y", "aux") else GRAD_TOL
    assert rel(port[f"moe|{what}"], ref[f"moe|{what}"]) <= tol


def _moe_leaves():
    return ["router", "w_down", "w_gate", "w_up"]


@pytest.mark.parametrize("leaf", _moe_leaves())
def test_moe_weight_gradients_match_reference_mesh(runs, leaf):
    _, ref, port = runs
    want = ref[f"moe|gp|{leaf}"]
    assert port[f"moe|gp|{leaf}"].shape == want.shape
    assert rel(port[f"moe|gp|{leaf}"], want) <= GRAD_TOL


@pytest.mark.parametrize("what", ["y", "gh", "cache|c", "cache|h",
                                  "cache|m", "cache|n"])
def test_slstm_sharded_matches_reference(runs, what):
    _, ref, port = runs
    tol = GRAD_TOL if what == "gh" else FWD_TOL
    assert rel(port[f"slstm|{what}"], ref[f"slstm|{what}"]) <= tol


@pytest.mark.parametrize("leaf", ["b_f", "norm.w", "rf", "ri", "ro", "rz",
                                  "w_out", "wf", "wi", "wo", "wz"])
def test_slstm_recurrent_weight_gradients_match_reference(runs, leaf):
    _, ref, port = runs
    assert rel(port[f"slstm|gp|{leaf}"], ref[f"slstm|gp|{leaf}"]) \
        <= GRAD_TOL


@pytest.mark.parametrize("d,m", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_compressed_psum_matches_reference(runs, d, m):
    """Against the reference's ``shard_map`` run op by op: the error bit
    for bit, the total to float32 summation order."""
    _, ref, port = runs
    np.testing.assert_array_equal(port[f"psum|err|{d}-{m}"],
                                  ref["psum|err"][d:d + 1, m:m + 1])
    total = port[f"psum|total|{d}-{m}"]
    np.testing.assert_allclose(total, ref["psum|total"][d:d + 1],
                               rtol=0, atol=FWD_TOL * float(
                                   np.abs(ref["psum|total"]).max()))


@pytest.mark.parametrize("d,m", [(0, 0), (1, 1)])
def test_compressed_psum_within_ulps_of_the_jitted_reference(runs, d, m):
    """Under ``jax.jit`` XLA fuses the quantization and rounds the error
    differently from its own op-by-op run (up to a few float32 ulps of the
    input); the port computes the op-by-op arithmetic."""
    _, ref, port = runs
    x_max = float(np.abs(ref["psum|err_jit"]).max()) * 254
    np.testing.assert_allclose(port[f"psum|err|{d}-{m}"],
                               ref["psum|err_jit"][d:d + 1, m:m + 1],
                               rtol=0, atol=1e-6 * x_max)
    assert rel(port[f"psum|total|{d}-{m}"],
               ref["psum|total_jit"][d:d + 1]) <= FWD_TOL


def _ckpt_leaves():
    return [leaf for arch, key, leaf in _shard_keys()
            if arch == mc.PLACE_ARCHS[0] and key == "22"]


@pytest.mark.parametrize("leaf", _ckpt_leaves())
def test_restore_onto_another_mesh_is_bit_for_bit(runs, leaf):
    inp, _, port = runs
    whole = inp[f"place|{mc.PLACE_ARCHS[0]}|{leaf}"]
    got = mc.sub(port, f"ckpt|{leaf}")
    assert sorted(got) == [f"{r}-0" for r in range(4)]
    for c, shard in got.items():
        pl = str(port[f"ckpt|placements|{leaf}|{c}"])
        r = int(c.split("-")[0])
        if "Shard(dim=" in pl:
            dim = int(pl.split("Shard(dim=")[1].split(")")[0])
            want = np.split(whole, 4, axis=dim)[r]
        else:
            want = whole
        np.testing.assert_array_equal(shard, want)
