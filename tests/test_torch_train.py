"""The port's training path (ROADMAP A12e) against the JAX package's, on the CPU.

The same seeded NumPy inputs go through both packages: the data pipeline,
AdamW, the local half of gradient compression, the loss and its gradients
for all ten registered archs at ``reduced()`` size, one ``make_train_step``
and ``plan_table``.  The JAX package's parameters (and train state) are
carried into the port with ``lm_params_from_numpy`` /
``train_state_from_numpy``.

Tolerances (float32 everywhere; both packages compute the same float32
arithmetic in another order):

- ``LOSS_TOL`` = 1e-5: the loss (~7 at vocab 512), about 80 float32 ulps;
  what the serving tests hold logits to.
- ``GRAD_TOL`` = 1e-4, relative to each gradient leaf's largest entry:
  backpropagation through two groups of blocks sums in another order at
  every product (the worst leaf measured here, xLSTM's mLSTM input gate,
  sits at ~1.2e-5 of its max).
- ``ADAM_TOL`` = 1e-6 (absolute, on parameters of magnitude <= 1 and
  learning rates <= 1e-2): an update is ``lr * m / (sqrt(v) + eps)``, a
  few float32 roundings of a term of size <= lr; ``pow`` and ``cos`` of
  the schedule may differ by an ulp between XLA and PyTorch.
- bf16 parameters: the new value is rounded to bf16 in both packages, so
  they agree within one bf16 ulp (2^-8 relative) where a float32
  difference straddles a rounding boundary.

Everything integer or copied (the pipeline's arrays, int8 payloads and
scales, the remat modes of the port against each other) is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jcfg
from repro.data import pipeline as jpipe
from repro.launch.report import plan_table as j_plan_table
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import common as jcommon
from repro.models.transformer import LM as JLM
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp

import repro_torch.configs as tcfg
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.report import plan_table
from repro_torch.launch.steps import make_train_step
from repro_torch.models import common as tcommon
from repro_torch.models.common import tree_leaves_with_path, tree_map
from repro_torch.models.transformer import (LM, ParallelCtx,
                                            lm_params_from_numpy,
                                            train_state_from_numpy)
from repro_torch.optim import adamw
from repro_torch.optim import compression as tcomp

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_TOL = 1e-6
BF16_ULP = 2.0 ** -8
CPU = torch.device("cpu")
ARCHS = tcfg.list_archs()
# the Mackey-Glass task of the train phase of chip_smoke.py (LARGE_1024,
# int8-CSD, the readout fitted on steps 500-2000): the worst test NRMSE of
# the port on the CPU (one thread) over the natural row order and eight
# seeded row permutations of the fit, which sum the float32 Gram in
# other orders as another device does.  At examples/quickstart.py's ridge
# of 1e-6 that sum's rounding decides the fit (test NRMSE 0.15-6.68 here;
# the reference's own run gives 1.737); at 1e-2 the fit is well posed
# (0.0099-0.0104).  chip_smoke.py's MG_NRMSE_BOUND is 1.5x these.
MG_RIDGES = (1e-6, 1e-2)
MG_CPU_WORST = {1e-6: 6.6766281, 1e-2: 0.0104129}


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
    """These tensors are small: one PyTorch thread per test keeps the
    suite's parallel workers from oversubscribing the cores (restored
    after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    """A JAX tree -> NumPy, floats as float32 (bf16 -> f32 is exact)."""
    def one(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return np.asarray(a.astype(jnp.float32))
        return np.asarray(a)
    return jax.tree.map(one, tree)


def t(a, dtype=None):
    x = torch.as_tensor(np.asarray(a))
    return x if dtype is None else x.to(dtype)


def flat(tree) -> dict:
    """{"a/b/c": leaf} in the reference's leaf order."""
    return {"/".join(map(str, p)): x for p, x in tree_leaves_with_path(tree)}


def rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# data/pipeline.py: bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("vocab,seq,batch,structure",
                         [(97, 32, 8, 0.8), (50, 200, 4, 1.0),
                          (100352, 16, 2, 0.8), (512, 64, 6, 0.0)])
def test_lm_batch_equals_reference(seed, vocab, seq, batch, structure):
    cfg = tpipe.LMStreamConfig(vocab_size=vocab, seq_len=seq,
                               global_batch=batch, seed=seed,
                               structure=structure)
    jcfg_ = jpipe.LMStreamConfig(vocab_size=vocab, seq_len=seq,
                                 global_batch=batch, seed=seed,
                                 structure=structure)
    for step in (0, 5):
        got = tpipe.lm_batch(cfg, step)["tokens"]
        want = jpipe.lm_batch(jcfg_, step)["tokens"]
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for n in (2, batch // 2):
        for shard in range(n):
            np.testing.assert_array_equal(
                tpipe.lm_batch(cfg, 7, shard, n)["tokens"],
                jpipe.lm_batch(jcfg_, 7, shard, n)["tokens"])


def test_lm_batch_learnable_and_sharded():
    """The reference's own checks (tests/test_substrate.py), on the port."""
    cfg = tpipe.LMStreamConfig(vocab_size=50, seq_len=200, global_batch=4,
                               structure=1.0)
    toks = tpipe.lm_batch(cfg, 0)["tokens"]
    mult = 6364136223846793005 % 50
    pred = (toks[:, :-1].astype(np.int64) * mult + 12345) % 50
    assert (pred == toks[:, 1:]).mean() > 0.99
    cfg = tpipe.LMStreamConfig(vocab_size=97, seq_len=32, global_batch=8,
                               seed=3)
    s0 = tpipe.lm_batch(cfg, 5, shard=0, n_shards=2)["tokens"]
    s1 = tpipe.lm_batch(cfg, 5, shard=1, n_shards=2)["tokens"]
    assert s0.shape == (4, 33) and not np.array_equal(s0, s1)


@pytest.mark.parametrize("n,tau,seed", [(500, 17, 0), (300, 30, 4),
                                        (3000, 17, 0)])
def test_mackey_glass_equals_reference(n, tau, seed):
    got = tpipe.mackey_glass(n, tau=tau, seed=seed)
    want = jpipe.mackey_glass(n, tau=tau, seed=seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("n", [100, 701])
def test_reservoir_tasks_equal_reference(n, seed):
    for name, kw in (("narma10", {}), ("channel_equalization", {}),
                     ("channel_equalization", {"snr_db": 12.0}),
                     ("memory_capacity_task", {"max_delay": 7})):
        got = getattr(tpipe, name)(n, seed=seed, **kw)
        want = getattr(jpipe, name)(n, seed=seed, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# optim/adamw.py
# ---------------------------------------------------------------------------
def _grad_tree(rng, shapes, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            if not isinstance(s, dict) else _grad_tree(rng, s, scale)
            for k, s in shapes.items()}


# insertion order unlike the sorted order jax.tree.leaves walks
_SHAPES = {"z": (3, 5), "a": {"w": (7,), "b": (2, 2, 2)}, "m": (4,)}


@pytest.mark.parametrize("warmup,total", [(20, 100), (0, 10), (5, 5)])
def test_schedule_matches_reference(warmup, total):
    jc = jadamw.AdamWConfig(lr=3e-3, warmup_steps=warmup, total_steps=total)
    tc = adamw.AdamWConfig(lr=3e-3, warmup_steps=warmup, total_steps=total)
    steps = np.arange(0, total + 20, dtype=np.int32)
    got = adamw.schedule(tc, torch.as_tensor(steps))
    want = np.asarray(jadamw.schedule(jc, jnp.asarray(steps)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_global_norm_and_clip_match_reference(scale):
    rng = np.random.default_rng(1)
    g = _grad_tree(rng, _SHAPES, scale)
    jn = jadamw.global_norm(jax.tree.map(jnp.asarray, g))
    tg = tree_map(t, g)
    # per-leaf sums of squares in another order inside a leaf (XLA's
    # reduction tree, PyTorch's): within a few float32 ulps
    np.testing.assert_allclose(float(adamw.global_norm(tg)), float(jn),
                               rtol=1e-6)
    got, norm = adamw.clip_by_global_norm(tg, 1.0)
    want, jnorm = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                             1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    fw = flat(to_np(want))
    for name, x in flat(got).items():
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), fw[name], rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_updates_match_reference(dtype):
    rng = np.random.default_rng(2)
    p = _grad_tree(rng, _SHAPES, 0.5)
    jc = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    tc = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), p)
    tp = tree_map(lambda a: t(a, getattr(torch, dtype)), p)
    jopt, topt = jadamw.init_state(jp), adamw.init_state(tp)
    assert topt["step"].dtype == torch.int32 and topt["step"].ndim == 0
    for i in range(3):
        g = _grad_tree(rng, _SHAPES, 10.0 ** (i - 1))
        jp, jopt, jm = jadamw.apply_updates(
            jp, jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), g),
            jopt, jc)
        tp, topt, tm = adamw.apply_updates(
            tp, tree_map(lambda a: t(a, getattr(torch, dtype)), g), topt,
            tc)
        assert int(topt["step"]) == int(jopt["step"]) == i + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for name, x in flat(tp).items():
            want = flat(to_np(jp))[name]
            assert str(x.dtype) == f"torch.{dtype}"
            tol = ADAM_TOL if dtype == "float32" else BF16_ULP
            np.testing.assert_allclose(x.float().numpy(), want, rtol=tol,
                                       atol=ADAM_TOL)
        for key in ("m", "v"):
            fw = flat(to_np(jopt[key]))
            for name, x in flat(topt[key]).items():
                assert x.dtype == torch.float32
                np.testing.assert_allclose(x.numpy(), fw[name], rtol=1e-5,
                                           atol=1e-12)


def test_weight_decay_alone():
    """Zero gradients: the step only decays, p * (1 - lr * wd)."""
    p = {"w": torch.linspace(-1, 1, 11)}
    cfg = adamw.AdamWConfig(lr=0.5, weight_decay=0.2, warmup_steps=0,
                            total_steps=1, min_lr_ratio=1.0)
    new, opt, _ = adamw.apply_updates(p, {"w": torch.zeros(11)},
                                      adamw.init_state(p), cfg)
    np.testing.assert_allclose(new["w"].numpy(), p["w"].numpy() * 0.9,
                               rtol=1e-6, atol=1e-7)
    assert not opt["m"]["w"].any() and not opt["v"]["w"].any()


def test_bias_correction_makes_the_first_step_a_sign_step():
    """Step 1 without decay: m / bc1 = g and v / bc2 = g^2, so the update
    is lr * g / (|g| + eps) -- the bias correction at work."""
    g = torch.tensor([0.5, -2.0, 1e-3, -3e-2])
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=1, min_lr_ratio=1.0, clip_norm=1e9)
    p = {"w": torch.zeros(4)}
    new, opt, m = adamw.apply_updates(p, {"w": g}, adamw.init_state(p), cfg)
    np.testing.assert_allclose(new["w"].numpy(),
                               (-0.1 * g / (g.abs() + 1e-8)).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(opt["m"]["w"].numpy(), (0.1 * g).numpy(),
                               rtol=1e-6)
    assert float(m["lr"]) == pytest.approx(0.1)


# ---------------------------------------------------------------------------
# optim/compression.py (the local half)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,block", [((4096,), 2048), ((3, 1000), 2048),
                                        ((5, 7, 11), 64), ((1,), 16)])
def test_quantize_block_int8_matches_reference(shape, block):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 10)).astype(np.float32)
    x.reshape(-1)[:block // 2] = 0.0           # a first block half empty
    q, scale, pad = tcomp.quantize_block_int8(t(x), block)
    jq, jscale, jpad = jcomp.quantize_block_int8(jnp.asarray(x), block)
    assert pad == jpad == (-x.size) % block
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    got = tcomp.dequantize_block_int8(q, scale, pad, shape)
    want = jcomp.dequantize_block_int8(jq, jscale, jpad, shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compress_grads_with_feedback_matches_reference():
    rng = np.random.default_rng(6)
    g = _grad_tree(rng, {"a": (3000,), "b": {"c": (17, 5)}})
    tg = tree_map(t, g)
    jg = jax.tree.map(jnp.asarray, g)
    res, jres = tcomp.init_residuals(tg), jcomp.init_residuals(jg)
    for _ in range(3):
        comp, res = tcomp.compress_grads_with_feedback(tg, res)
        jc, jres = jcomp.compress_grads_with_feedback(jg, jres)
        for name, x in flat(comp).items():
            np.testing.assert_array_equal(x.numpy(), flat(to_np(jc))[name])
        for name, x in flat(res).items():
            np.testing.assert_allclose(x.numpy(), flat(to_np(jres))[name],
                                       rtol=0, atol=1e-7)


def test_compressed_psum_waits_for_a12f2():
    """The reduction over a mesh axis is ported (held against the
    reference's ``shard_map`` in ``test_torch_mesh.py``); without a mesh
    it names what it needs."""
    with pytest.raises(ValueError, match="mesh"):
        tcomp.compressed_psum(torch.ones(4), "data")


# ---------------------------------------------------------------------------
# the loss: cross entropy, LM.loss and its gradients, remat
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked, z_loss):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, 9, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 9))
    mask = (rng.random((3, 9)) < 0.6) if masked else None
    got = tcommon.cross_entropy(t(logits), t(labels),
                                None if mask is None else t(mask), z_loss)
    want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask),
                                 z_loss)
    assert abs(float(got) - float(want)) <= LOSS_TOL


def test_cross_entropy_all_masked_is_zero():
    loss = tcommon.cross_entropy(torch.randn(2, 3, 5),
                                 torch.zeros(2, 3, dtype=torch.long),
                                 torch.zeros(2, 3))
    assert float(loss) == 0.0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_cross_entropy_streamed_matches_reference(softcap, masked):
    """Sequence 23 in chunks of 8: two checkpointed chunks and a remainder
    of 7; the loss and the gradients of x and the table."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 23, 16)).astype(np.float32)
    table = (rng.standard_normal((40, 16)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 40, (2, 23))
    mask = (rng.random((2, 23)) < 0.7) if masked else None

    def jloss(x_, tab):
        return jcommon.cross_entropy_streamed(
            x_, tab, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), softcap, chunk=8)

    jl, (jgx, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    tx, tt = t(x).requires_grad_(), t(table).requires_grad_()
    loss = tcommon.cross_entropy_streamed(
        tx, tt, t(labels), None if mask is None else t(mask), softcap,
        chunk=8)
    gx, gt = torch.autograd.grad(loss, (tx, tt))
    assert abs(float(loss) - float(jl)) <= LOSS_TOL
    assert rel_err(gx, jgx) <= GRAD_TOL and rel_err(gt, jgt) <= GRAD_TOL
    # the same as one dense cross entropy over the whole sequence
    logits = t(x) @ t(table).T
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    dense = tcommon.cross_entropy(logits, t(labels),
                                  None if mask is None else t(mask))
    assert abs(float(loss) - float(dense)) <= LOSS_TOL


def _pair(arch, **over):
    cfg = tcfg.reduced(tcfg.get_config(arch)).replace(dtype="float32",
                                                      **over)
    rcfg = jcfg.reduced(jcfg.get_config(arch)).replace(dtype="float32",
                                                       **over)
    jlm = JLM(rcfg)
    jp = jlm.init(jax.random.PRNGKey(1)).params
    return cfg, jlm, jp, lm_params_from_numpy(to_np(jp), cfg, device=CPU)


def _batches(cfg, b, s, seed=0):
    """A (B, S+1) token batch for both packages (int32 for JAX, int64 for
    the port), plus patches / frames where the config takes them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": t(toks)}
    if cfg.frontend == "vision":
        pt = rng.standard_normal((b, 4, cfg.d_model)).astype(np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(pt), t(pt)
    if cfg.encoder is not None:
        fr = rng.standard_normal((b, cfg.encoder.seq_len,
                                  cfg.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(fr), t(fr)
    return jb, tb


_REF_GRADS: dict = {}


def _ref_value_and_grad(arch):
    """The reference's loss and gradients for ``arch``: one compile per
    arch per worker, shared by the cases that need it."""
    if arch not in _REF_GRADS:
        cfg, jlm, jp, tp = _pair(arch)
        jb, tb = _batches(cfg, 2, 16)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jlm.loss(p, jb)))(jp)
        _REF_GRADS[arch] = (cfg, tp, tb, float(loss), flat(to_np(grads)))
    return _REF_GRADS[arch]


def _port_value_and_grad(cfg, params, batch):
    lm = LM(cfg, device=CPU)
    req = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    loss = lm.loss(req, batch)
    names = list(flat(req))
    grads = torch.autograd.grad(loss, list(flat(req).values()))
    return loss.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """float32 loss within LOSS_TOL and every gradient leaf within
    GRAD_TOL of its largest entry, against ``jax.value_and_grad`` (the
    MoE aux loss included; whisper with frames, internvl2 with patches)."""
    cfg, tp, tb, jloss, jgrads = _ref_value_and_grad(arch)
    loss, grads = _port_value_and_grad(cfg, tp, tb)
    assert abs(float(loss) - jloss) <= LOSS_TOL
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        assert g.shape == jgrads[name].shape, name
        assert rel_err(g, jgrads[name]) <= GRAD_TOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_are_bit_identical(arch):
    """none, dots and full give the same loss and gradients, bit for
    bit (recomputation repeats the same operations on the same inputs)."""
    cfg, tp, tb, _, _ = _ref_value_and_grad(arch)
    runs = [_port_value_and_grad(cfg.replace(remat=mode), tp, tb)
            for mode in ("none", "dots", "full")]
    loss0, g0 = runs[0]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, loss0)
        for name, g in grads.items():
            assert torch.equal(g, g0[name]), name


def test_moe_aux_loss_is_in_the_loss():
    """olmoe's loss is the cross entropy plus the routers' aux losses: a
    zero aux weight moves the loss by what the reference's aux adds."""
    cfg, tp, tb, jloss, _ = _ref_value_and_grad("olmoe-1b-7b")
    zero = dataclasses.replace(cfg.moe, aux_loss=0.0, router_z_loss=0.0)
    lm0 = LM(cfg.replace(moe=zero), device=CPU)
    with torch.no_grad():
        ce = float(lm0.loss(tp, tb))
        full = float(LM(cfg, device=CPU).loss(tp, tb))
    assert full - ce > 1e-4
    assert abs(full - jloss) <= LOSS_TOL


def test_loss_streams_the_vocab_above_2_to_the_24(monkeypatch):
    """S * V > 2^24 takes the streamed cross entropy: the same loss as the
    dense cross entropy on the same final activations."""
    import repro_torch.models.transformer as tr
    cfg = tcfg.reduced(tcfg.get_config("stablelm-1.6b")).replace(
        dtype="float32", vocab_size=1 << 14, n_layers=1)
    lm = LM(cfg, device=CPU)
    params = lm.init(torch.Generator().manual_seed(0)).params
    rng = np.random.default_rng(0)
    toks = t(rng.integers(0, cfg.vocab_size, (1, 1026)))  # S = 1025 > 2^10
    called = []

    def spy(*a, **kw):
        called.append(tuple(a[0].shape))
        return tcommon.cross_entropy_streamed(*a, **kw)

    monkeypatch.setattr(tr, "cross_entropy_streamed", spy)
    loss, grads = _port_value_and_grad(cfg, params, {"tokens": toks})
    assert called == [(1, 1025, cfg.d_model)]
    assert all(torch.isfinite(g).all() for g in grads.values())
    # the dense path on the same inputs
    with torch.no_grad():
        x = lm._embed(params, toks[:, :-1])
        x, _ = lm._train_stack(params, x, ParallelCtx())
        x = tcommon.apply_norm(x, params["final_norm"], cfg.norm)
        dense = tcommon.cross_entropy(x @ params["lm_head"], toks[:, 1:])
    assert abs(float(loss) - float(dense)) <= LOSS_TOL


def test_loss_waits_for_a_mesh():
    """The loss runs on a mesh (``test_torch_mesh_train.py``) but for int8
    leaves, which wait for ROADMAP A12f3."""
    cfg = tcfg.reduced(tcfg.get_config("stablelm-1.6b"))
    lm = LM(cfg, device=CPU)
    params = {"embed": {"q": torch.zeros((2, 2), dtype=torch.int8),
                        "scale": torch.ones(2)}}
    with pytest.raises(NotImplementedError, match="A12f3"):
        lm.loss(params, {"tokens": torch.zeros(1, 3, dtype=torch.long)},
                ParallelCtx(mesh=object()))


# ---------------------------------------------------------------------------
# launch/steps.make_train_step
# ---------------------------------------------------------------------------
_STEP_CFG = dict(lr=1e-2, warmup_steps=0, total_steps=10)


@pytest.mark.parametrize("arch,batch", [("stablelm-1.6b", 4),
                                        ("xlstm-350m", 4),
                                        ("olmoe-1b-7b", 4)])
def test_train_step_matches_reference(arch, batch):
    """One step from the same state: parameters, m, v, step and the
    metrics against the reference's jitted step (stablelm k = 2, xlstm
    k = 4, olmoe k = 2 with the MoE aux loss)."""
    cfg, jlm, jp, _ = _pair(arch)
    assert cfg.microbatches > 1
    jstate = {"params": jp, "opt": jadamw.init_state(jp)}
    jb, tb = _batches(cfg, batch, 16, seed=1)
    jfn = jax.jit(j_make_train_step(jlm, None,
                                    jadamw.AdamWConfig(**_STEP_CFG)))
    jnew, jm = jfn(jstate, jb)
    state = train_state_from_numpy(to_np(jstate), cfg, device=CPU)
    before = {n: x for n, x in flat(state).items()}
    fn = make_train_step(LM(cfg, device=CPU), None,
                         adamw.AdamWConfig(**_STEP_CFG))
    new, m = fn(state, tb)
    assert new is state
    for name, x in flat(new).items():       # written in place
        assert x is before[name], name
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_TOL)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    assert new["opt"]["step"].dtype == torch.int32
    want = flat(to_np(jnew))
    for name, x in flat(new).items():
        if name.startswith("opt/m") or name.startswith("opt/v"):
            assert rel_err(x, want[name]) <= 2 * GRAD_TOL, name
        elif name.startswith("params"):
            g = want["opt/m" + name[len("params"):]] / 0.1   # step 1: m = g/10
            np.testing.assert_array_less(
                np.abs(x.numpy() - want[name]), _update_tol(g, tol=GRAD_TOL))


def _update_tol(g, tol):
    """Per element, how far two first AdamW steps may land apart when their
    gradients ``g`` agree within ``dg = tol * max|g|``: the step is ``lr g
    / (|g| + eps)`` (bias-corrected), whose slope ``lr eps / (|g| +
    eps)^2`` is at most ``lr eps / g^2``, so it moves by at most ``2 lr
    min(1, eps dg / g^2)`` (a gradient within noise of 0 may take either
    sign: up to 2 lr), plus ADAM_TOL of rounding."""
    lr, eps = _STEP_CFG["lr"], 1e-8
    dg = tol * np.abs(g).max()
    with np.errstate(divide="ignore"):
        slope = np.minimum(1.0, eps * dg / np.square(g))
    return ADAM_TOL + 2 * lr * slope


def test_train_step_single_microbatch_keeps_param_dtype_grads():
    """k == 1 in bf16: the step runs (gradients in bf16 until the clip),
    moments stay float32 and the bf16 parameters move."""
    cfg = tcfg.reduced(tcfg.get_config("stablelm-1.6b")).replace(
        microbatches=1, dtype="bfloat16")
    lm = LM(cfg, device=CPU)
    params = lm.init(torch.Generator().manual_seed(0)).params
    state = {"params": params, "opt": adamw.init_state(params)}
    old = {n: x.clone() for n, x in flat(params).items()}
    _, tb = _batches(cfg, 2, 8)
    _, m = make_train_step(lm, None, adamw.AdamWConfig(
        **_STEP_CFG))(state, tb)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert all(x.dtype == torch.float32
               for x in flat(state["opt"]["m"]).values())
    moved = [not torch.equal(x, old[n]) for n, x in flat(params).items()]
    assert all(moved)


def test_tiny_preset_loss_falls_over_40_steps():
    """examples/train_lm.py's tiny preset and optimizer at batch 8 x 64
    tokens of ``lm_batch``: the mean of the last 5 losses is below the
    mean of the first 5 minus 0.3, the example's own check."""
    cfg = tcfg.ModelConfig(
        name="tiny-lm", family="dense", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=2048,
        tie_embeddings=True, remat="none", dtype="float32")
    lm = LM(cfg, device=CPU)
    params = lm.init(torch.Generator().manual_seed(0)).params
    state = {"params": params, "opt": adamw.init_state(params)}
    stream = tpipe.LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=8, seed=0)
    step = make_train_step(lm, None, adamw.AdamWConfig(
        lr=3e-3, warmup_steps=20, total_steps=100))
    torch.set_num_threads(2)
    losses = []
    for i in range(40):
        batch = {"tokens": torch.as_tensor(
            tpipe.lm_batch(stream, i)["tokens"], dtype=torch.long)}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_train_step_waits_for_a_mesh():
    """A mesh and ``grad_shardings`` build a step (their runs are held in
    ``test_torch_mesh_train.py``); without a mesh ``grad_shardings`` has
    nothing to place and the step equals the plain one bit for bit."""
    from repro_torch.launch.mesh import AbstractMesh
    cfg = tcfg.reduced(tcfg.get_config("stablelm-1.6b")).replace(
        dtype="float32")
    lm = LM(cfg, device=CPU)
    assert callable(make_train_step(lm, AbstractMesh((2, 2),
                                                     ("data", "model"))))
    outs = []
    for grad_sh in (None, {}):
        params = lm.init(torch.Generator().manual_seed(0)).params
        state = {"params": params, "opt": adamw.init_state(params)}
        _, tb = _batches(cfg, 4, 8)
        _, m = make_train_step(lm, None, adamw.AdamWConfig(**_STEP_CFG),
                               grad_shardings=grad_sh)(state, tb)
        outs.append((m["loss"], flat(state)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(outs[0][1][k], outs[1][1][k]) for k in outs[0][1])


def test_train_state_from_numpy_keeps_dtypes():
    cfg = tcfg.reduced(tcfg.get_config("stablelm-1.6b"))      # bf16
    rcfg = jcfg.reduced(jcfg.get_config("stablelm-1.6b"))
    jp = JLM(rcfg).init(jax.random.PRNGKey(0)).params
    state = train_state_from_numpy(
        to_np({"params": jp, "opt": jadamw.init_state(jp)}), cfg,
        device=CPU)
    assert state["opt"]["step"].dtype == torch.int32
    assert state["opt"]["step"].ndim == 0
    for name, x in flat(state["params"]).items():
        assert state["opt"]["m"] is not None
        assert flat(state["opt"]["m"])[name].dtype == torch.float32
        assert flat(state["opt"]["v"])[name].shape == x.shape
    assert flat(state["params"])["embed"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# launch/report.plan_table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [(128, 0.9, 32, "csd"), (96, 0.5, 32, "pn"),
                                  (200, 0.97, 64, "csd")])
def test_plan_table_equals_reference(case):
    from repro.core.sparse import FixedMatrix as JFixed
    from repro.core.sparse import random_sparse_matrix
    from repro.plan import plan_for as j_plan_for
    from repro_torch.core.bitplanes import DigitPlanes
    from repro_torch.core.sparse import FixedMatrix as TFixed
    from repro_torch.plan import plan_for
    dim, es, block, mode = case
    rng = np.random.default_rng(dim)
    jplans, tplans = [], []
    for k in range(2):
        dense = random_sparse_matrix(dim, dim, es, rng) * 0.1
        ref = JFixed.compile(dense, weight_bits=8, mode=mode, block=block,
                             rng=rng)
        planes = DigitPlanes(pos=ref.planes.pos, neg=ref.planes.neg,
                             mode=mode, source_bits=8)
        port = TFixed.from_parts(np.asarray(ref.q), ref.scale, planes, block)
        jplans.append(j_plan_for(ref))
        tplans.append(plan_for(port))
    assert plan_table(tplans) == j_plan_table(jplans)


# ---------------------------------------------------------------------------
# the Mackey-Glass bound of chip_smoke.py's train phase
# ---------------------------------------------------------------------------
def test_mackey_glass_nrmse_at_large_1024():
    """The paper's Sec. II task as examples/quickstart.py runs it, at
    LARGE_1024 on the CPU (the B2 twin), fitted over nine row orders:
    at a ridge of 1e-2 every order's test NRMSE stays under
    ``MG_CPU_WORST`` (+10 % for another CPU's sums), the bound
    chip_smoke.py is written from; at 1e-6 the orders' NRMSEs spread
    over more than 2x (the fit follows the Gram's rounding) and stay
    finite."""
    from repro_torch.configs.esn_paper import LARGE_1024
    from repro_torch.core.esn import (fit_readout, init_esn, nrmse, predict,
                                      run_readout, run_reservoir)
    sig = tpipe.mackey_glass(3000, seed=0)
    u, y = t(sig[:-1, None]), t(sig[1:, None])
    params = init_esn(LARGE_1024, device=CPU)
    states = run_reservoir(params, u)
    for lam in MG_RIDGES:
        tests = []
        for k in range(9):
            rows = (torch.arange(500, 2000) if k == 0 else 500 + torch.randperm(
                1500, generator=torch.Generator().manual_seed(k)))
            fit = fit_readout(params, states[rows], y[rows], lam=lam)
            tests.append(float(nrmse(predict(fit, states[2000:]),
                                     y[2000:])))
        fit = fit_readout(params, states[500:2000], y[500:2000], lam=lam)
        served = float(nrmse(run_readout(fit, u)[2000:], y[2000:]))
        assert served == pytest.approx(tests[0], rel=1e-4)   # readout sums
        assert np.isfinite(tests).all()
        if lam == 1e-2:
            assert max(tests) <= 1.1 * MG_CPU_WORST[lam]
        else:
            assert max(tests) > 2 * min(tests)
