"""The port's checkpoint store against the JAX package's, on the CPU.

One step written by either package restores in the other bit for bit: the
same directory layout, leaf file names and manifest (shapes, logical
dtypes, sha256), bf16 leaves stored as their bytes.  The tree mixes
float32, bf16, int32, a 0-d ``step`` and a list (its entries named by
index), with dict keys out of sorted order (both packages name and order
leaves as ``jax.tree_util`` walks them: keys sorted).  Integrity checks
(a torn ``.tmp``, a corrupted ``.npy``), retention and ``save_async`` are
held to the same behaviour in both packages.  Everything here is exact.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import store as jstore

from repro_torch.checkpoint import store
from repro_torch.models.common import tree_leaves_with_path


@pytest.fixture(scope="module", autouse=True)
def _release_xla_executables():
    """Free the XLA executables this module's reference calls compiled once
    its tests in this worker are done: each holds JIT memory mappings, and
    a test worker that keeps every module's executables can pass the
    kernel's per-process mapping limit (``vm.max_map_count``) inside a
    later compile, which then aborts the worker (ROADMAP C-port-5)."""
    yield
    jax.clear_caches()


CPU = torch.device("cpu")


def _trees(seed=0):
    """The same tree for both packages: (JAX arrays, port tensors)."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    bf = rng.standard_normal((2, 5)).astype(ml_dtypes.bfloat16)
    bf0 = np.asarray([1.5], ml_dtypes.bfloat16)   # (the reference cannot
    # store a 0-d bf16: numpy will not view a 0-d array as 2 bytes)
    i32 = rng.integers(-5, 5, (6,)).astype(np.int32)
    lst = [rng.standard_normal((2,)).astype(np.float32) for _ in range(3)]
    step = np.asarray(17, np.int32)

    def bf_t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                ).view(torch.bfloat16)

    jtree = {"z_params": {"w": jnp.asarray(f32), "emb": jnp.asarray(bf),
                          "scale": jnp.asarray(bf0)},
             "opt": {"step": jnp.asarray(step), "count": jnp.asarray(i32)},
             "layers": [jnp.asarray(a) for a in lst]}
    ttree = {"z_params": {"w": torch.from_numpy(f32.copy()), "emb": bf_t(bf),
                          "scale": bf_t(bf0)},
             "opt": {"step": torch.tensor(17, dtype=torch.int32),
                     "count": torch.from_numpy(i32.copy())},
             "layers": [torch.from_numpy(a.copy()) for a in lst]}
    return jtree, ttree


def _bits(x) -> np.ndarray:
    """A leaf's raw bits (bf16 as int16) for a bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_bitwise(port_tree, ref_tree):
    ref = dict(jax.tree_util.tree_flatten_with_path(ref_tree)[0])
    ref = {tuple(getattr(p, "key", getattr(p, "idx", p)) for p in k): v
           for k, v in ref.items()}
    got = tree_leaves_with_path(port_tree)
    assert [p for p, _ in got] == list(ref)          # the same leaf order
    for path, x in got:
        want = ref[path]
        assert isinstance(x, torch.Tensor)
        assert tuple(x.shape) == tuple(np.shape(want)), path
        assert str(x.dtype).removeprefix("torch.") == str(np.asarray(
            want).dtype), path
        np.testing.assert_array_equal(_bits(x), _bits(want), err_msg=path)


def test_leaf_names_and_manifest_equal_reference(tmp_path):
    jtree, ttree = _trees()
    dj = jstore.save(jtree, tmp_path / "ref", 3)
    dt = store.save(ttree, tmp_path / "port", 3)
    assert dj.name == dt.name == "step_00000003"
    names = sorted(p.name for p in dj.iterdir())
    assert names == sorted(p.name for p in dt.iterdir())
    assert "layers__1.npy" in names and "z_params__emb.npy" in names
    mj = json.loads((dj / "manifest.json").read_text())
    mt = json.loads((dt / "manifest.json").read_text())
    assert mt == mj            # shapes, logical dtypes and sha256 included
    assert mt["leaves"]["z_params__emb"]["dtype"] == "bfloat16"
    assert mt["leaves"]["z_params__emb"]["shape"] == [2, 5, 2]
    for name in names:
        assert (dj / name).read_bytes() == (dt / name).read_bytes(), name


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree = _trees(1)
    jstore.save(jtree, tmp_path, 5)
    assert store.latest_step(tmp_path) == 5
    zeros = {"z_params": {k: torch.zeros_like(v)
                          for k, v in ttree["z_params"].items()},
             "opt": {k: torch.zeros_like(v) for k, v in ttree["opt"].items()},
             "layers": [torch.zeros_like(v) for v in ttree["layers"]]}
    out = store.restore(zeros, tmp_path, 5)
    _assert_bitwise(out, jtree)
    assert list(out) == list(zeros)             # the caller's key order
    assert out["opt"]["step"].ndim == 0


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jtree, ttree = _trees(2)
    store.save(ttree, tmp_path, 9)
    assert jstore.latest_step(tmp_path) == 9
    out = jstore.restore(jtree, tmp_path, 9)
    _assert_bitwise(ttree, out)


def test_port_round_trip_into_fresh_tensors(tmp_path):
    _, ttree = _trees(3)
    store.save(ttree, tmp_path, 0)
    fresh = {"z_params": {k: torch.empty_like(v)
                          for k, v in ttree["z_params"].items()},
             "opt": {k: torch.empty_like(v) for k, v in ttree["opt"].items()},
             "layers": [torch.empty_like(v) for v in ttree["layers"]]}
    out = store.restore(fresh, tmp_path, 0)
    for (p, a), (q, b) in zip(tree_leaves_with_path(out),
                              tree_leaves_with_path(ttree)):
        assert p == q and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
        assert a.data_ptr() != b.data_ptr()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_torn_tmp_and_corrupt_leaf_are_skipped_by_both(tmp_path, pkg):
    """A crash mid-save leaves ``step_N.tmp`` (no manifest published); a
    corrupted ``.npy`` fails its sha256.  Both packages resume from the
    last good step, whichever wrote it."""
    jtree, ttree = _trees(4)
    save = (lambda s: store.save(ttree, tmp_path, s)) if pkg == "port" \
        else (lambda s: jstore.save(jtree, tmp_path, s))
    save(1)
    d2 = save(2)
    torn = tmp_path / "step_00000003.tmp"
    torn.mkdir()
    (torn / "opt__step.npy").write_bytes(b"half")
    for latest in (store.latest_step, jstore.latest_step):
        assert latest(tmp_path) == 2
    (d2 / "z_params__w.npy").write_bytes(b"garbage")
    for latest, verify in ((store.latest_step, store.verify),
                           (jstore.latest_step, jstore.verify)):
        assert not verify(d2)
        assert latest(tmp_path) == 1
    (tmp_path / "step_00000001" / "manifest.json").write_text("{not json")
    assert store.latest_step(tmp_path) is None
    assert jstore.latest_step(tmp_path) is None


def test_latest_step_of_a_missing_directory(tmp_path):
    assert store.latest_step(tmp_path / "none") is None


def test_shape_mismatch_rejected(tmp_path):
    store.save({"a": torch.zeros(2, 2)}, tmp_path, 0)
    with pytest.raises(ValueError, match="checkpoint"):
        store.restore({"a": torch.zeros(3, 3)}, tmp_path, 0)


def test_restore_waits_for_a_mesh(tmp_path):
    """``shardings=`` is ported (a re-planned mesh's restore is held in
    ``test_torch_mesh.py``); a leaf without a sharding comes back as
    without the argument."""
    store.save({"a": torch.arange(2.0)}, tmp_path, 0)
    back = store.restore({"a": torch.zeros(2)}, tmp_path, 0, shardings={})
    assert torch.equal(back["a"], torch.arange(2.0))
    back = store.restore({"a": torch.zeros(2)}, tmp_path, 0,
                         shardings={"a": None})
    assert torch.equal(back["a"], torch.arange(2.0))


@pytest.mark.parametrize("every,keep", [(1, 2), (2, 1), (1, 3)])
def test_checkpointer_retention_like_reference(tmp_path, every, keep):
    """Both packages keep the same steps, saving every ``every`` steps and
    keeping ``keep`` (plus at most the one in flight when it collected)."""
    ck = store.Checkpointer(tmp_path / "port", every=every, keep=keep)
    jck = jstore.Checkpointer(tmp_path / "ref", every=every, keep=keep)
    for s in range(7):
        ck.maybe_save({"a": torch.full((3,), float(s))}, s)
        jck.maybe_save({"a": jnp.full((3,), float(s))}, s)
    ck.finalize()
    jck.finalize()
    steps = sorted(p.name for p in (tmp_path / "port").glob("step_*"))
    assert len(steps) <= keep + 1
    assert store.latest_step(tmp_path / "port") == 6 - 6 % every
    assert jstore.latest_step(tmp_path / "ref") == 6 - 6 % every
    out = store.restore({"a": torch.zeros(3)}, tmp_path / "port",
                        6 - 6 % every)
    assert torch.equal(out["a"], torch.full((3,), float(6 - 6 % every)))


def test_save_async_joins_with_a_snapshot(tmp_path):
    """The host copy is taken before ``save_async`` returns: a state
    written in place afterwards (as ``make_train_step`` does) does not
    reach the files; the thread joins and the step verifies."""
    w = torch.arange(6, dtype=torch.float32)
    th = store.save_async({"w": w, "b": [torch.ones(2)]}, tmp_path, 4)
    w.add_(100.0)
    th.join(timeout=60)
    assert not th.is_alive()
    assert store.latest_step(tmp_path) == 4
    out = store.restore({"w": torch.zeros(6), "b": [torch.zeros(2)]},
                        tmp_path, 4)
    assert torch.equal(out["w"], torch.arange(6, dtype=torch.float32))
    assert torch.equal(out["b"][0], torch.ones(2))


def test_restore_places_leaves_like_tree_like(tmp_path):
    store.save({"a": torch.ones(2), "n": np.arange(3)}, tmp_path, 0)
    out = store.restore({"a": torch.zeros(2, device="meta"),
                         "n": np.zeros(3)}, tmp_path, 0)
    assert out["a"].device.type == "meta"
    assert out["n"].device == CPU and out["n"].dtype == torch.int64
