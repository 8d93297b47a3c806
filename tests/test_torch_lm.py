"""The port's LM serving path against the JAX package's, on the CPU.

The same seeded NumPy inputs go through both packages; the JAX package's
parameters are carried into the port with ``lm_params_from_numpy``.

Tolerances: float32 everywhere unless a test says otherwise.  Both
packages compute the same float32 arithmetic in another order (XLA's and
PyTorch's CPU products, softmax and reductions), so components and LM
logits (of magnitude ~4 at these sizes) agree within ``TOL`` = 1e-5,
about 80 float32 ulps of the largest logit.  The bf16 path rounds every
layer's activations to 8 significant bits in both packages, at places
where XLA and PyTorch round differently (XLA's CPU fuses some bf16
elementwise chains in float32); it is held to the reference's own bound
between two of its bf16 paths, rtol = atol = 0.15
(tests/test_arch_smoke.py's decode-vs-prefill check).  Integer results
(int8 quantization, greedy tokens, cache position tags) are exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jcfg
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import gqa as jgqa
from repro.models import quantize as jquant
from repro.models.transformer import LM as JLM

import repro_torch.configs as tcfg
from repro_torch.launch.steps import (make_ctx, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import gqa as tgqa
from repro_torch.models import quantize as tquant
from repro_torch.models.transformer import LM, lm_params_from_numpy

TOL = 1e-5
BF16_TOL = 0.15
CPU = torch.device("cpu")
DENSE = ["gemma-2b", "internvl2-76b", "mistral-nemo-12b", "qwen3-32b",
         "stablelm-1.6b"]
ARCHS = tcfg.list_archs()   # the dense five, MoE, MLA, recurrent, enc-dec


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


def close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(arch, dtype="float32", **over):
    cfg = tcfg.reduced(tcfg.get_config(arch)).replace(dtype=dtype, **over)
    rcfg = jcfg.reduced(jcfg.get_config(arch)).replace(dtype=dtype, **over)
    jlm = JLM(rcfg)
    jp = jlm.init(jax.random.PRNGKey(1)).params
    lm = LM(cfg, device=CPU)
    return cfg, jlm, jp, lm, lm_params_from_numpy(to_np(jp), cfg, device=CPU)


def _batches(cfg, rng, b, s):
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": t(toks)}
    if cfg.frontend == "vision":
        pt = rand(rng, b, 4, cfg.d_model)
        jb["patches"], tb["patches"] = jnp.asarray(pt), t(pt)
    if cfg.encoder is not None:    # whisper: stub frame embeddings
        fr = rand(rng, b, cfg.encoder.seq_len, cfg.d_model)
        jb["frames"], tb["frames"] = jnp.asarray(fr), t(fr)
    return toks, jb, tb


# ---------------------------------------------------------------------------
# models/common.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match(dtype):
    rng = np.random.default_rng(0)
    x, w, b = rand(rng, 3, 5, 64), rand(rng, 64), rand(rng, 64)
    jx = jnp.asarray(x).astype(dtype)
    tx = t(x, getattr(torch, dtype))
    tol = TOL if dtype == "float32" else 1e-2
    for plus_one in (False, True):
        got = tcommon.rmsnorm(tx, t(w), plus_one=plus_one)
        assert got.dtype == tx.dtype
        close(got, jcommon.rmsnorm(jx, jnp.asarray(w), plus_one=plus_one),
              tol)
    close(tcommon.layernorm(tx, t(w), t(b)),
          jcommon.layernorm(jx, jnp.asarray(w), jnp.asarray(b)), tol)
    for kind in ("rmsnorm", "layernorm"):
        p = {"w": w, "b": b} if kind == "layernorm" else {"w": w}
        close(tcommon.apply_norm(tx, {k: t(v) for k, v in p.items()}, kind),
              jcommon.apply_norm(jx, jax.tree.map(jnp.asarray, p), kind),
              tol)


@pytest.mark.parametrize("fraction", [1.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches(dtype, fraction):
    rng = np.random.default_rng(1)
    x = rand(rng, 2, 7, 3, 16)
    pos = np.arange(7)[None, :] + np.array([[0], [100]])
    close(tcommon.rope_angles(t(pos), 16, 1e6),
          jcommon.rope_angles(jnp.asarray(pos), 16, 1e6))
    got = tcommon.apply_rope(t(x, getattr(torch, dtype)), t(pos), 1e4,
                             fraction)
    want = jcommon.apply_rope(jnp.asarray(x).astype(dtype),
                              jnp.asarray(pos), 1e4, fraction)
    assert str(got.dtype).endswith(dtype)
    # bf16: sin/cos cast to bf16 in both, products rounded alike
    close(got, want, TOL if dtype == "float32" else 1e-2)
    if fraction < 1.0:   # stablelm: the dims past the rotary part pass
        np.testing.assert_array_equal(got[..., 4:].float().numpy(),
                                      np.asarray(want, np.float32)[..., 4:])


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
def test_mlp_matches(act):
    rng = np.random.default_rng(2)
    x = rand(rng, 2, 5, 32)
    p = {"w_up": rand(rng, 32, 48) / 6, "w_down": rand(rng, 48, 32) / 7}
    if act != "gelu":
        p["w_gate"] = rand(rng, 32, 48) / 6
    close(tcommon.mlp_apply(t(x), {k: t(v) for k, v in p.items()}, act),
          jcommon.mlp_apply(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                            act))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_and_logits_match(dtype):
    rng = np.random.default_rng(3)
    table = rand(rng, 50, 64)
    toks = rng.integers(0, 50, (2, 6))
    jt, tt = jnp.asarray(table).astype(dtype), t(table, getattr(torch, dtype))
    for scale in (False, True):   # gemma: x * sqrt(d) in x's dtype
        got = tcommon.embed_lookup(t(toks), tt, scale_by_sqrt_dim=scale)
        want = jcommon.embed_lookup(jnp.asarray(toks), jt,
                                    scale_by_sqrt_dim=scale)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    x = rand(rng, 2, 3, 64)
    for softcap in (None, 30.0):
        close(tcommon.logits_from_embedding(t(x), t(table), softcap),
              jcommon.logits_from_embedding(jnp.asarray(x),
                                            jnp.asarray(table), softcap))


def test_init_helpers_shapes_axes_and_scale():
    g = torch.Generator().manual_seed(0)
    w, axes = tcommon.dense_init(g, (256, 4, 8), ("embed", "heads", None),
                                 0, lead=(3,))
    assert w.shape == (3, 256, 4, 8) and axes == ("layers", "embed",
                                                  "heads", None)
    assert abs(float(w.std()) - 1 / 16) < 0.01     # 1/sqrt(fan_in 256)
    wo, _ = tcommon.dense_init(g, (4, 8, 64), ("heads", None, "embed"),
                               (0, 1), dtype=torch.bfloat16)
    assert wo.dtype == torch.bfloat16
    assert abs(float(wo.float().std()) - 32 ** -0.5) < 0.02
    meta, _ = tcommon.dense_init(g, (1 << 20, 1 << 20), (None, None),
                                 device=torch.device("meta"))
    assert meta.is_meta and meta.shape == (1 << 20, 1 << 20)
    n = tcommon.norm_init(8, "layernorm", lead=(2,), device=CPU)
    assert n["w"][0].shape == (2, 8) and n["b"][1] == ("layers", None)
    sp = tcommon.split_tree({"a": (torch.ones(2), ("x",)),
                             "b": {"c": (torch.zeros(3), (None,))}})
    assert sp.axes == {"a": ("x",), "b": {"c": (None,)}}
    assert tcommon.tree_leaves(sp.params)[1].shape == (3,)


# ---------------------------------------------------------------------------
# models/attention.py
# ---------------------------------------------------------------------------
ATTN_CASES = [  # (hq, hkv, sq, skv, q_offset, causal, window, softcap)
    (4, 4, 12, 12, 0, True, None, None),      # MHA
    (4, 2, 12, 12, 0, True, None, None),      # GQA
    (4, 1, 12, 12, 0, True, None, None),      # MQA
    (4, 2, 12, 12, 0, True, 5, None),         # sliding window
    (4, 2, 6, 18, 12, True, None, None),      # prefill continuation
    (4, 2, 6, 18, 12, True, 7, 20.0),         # ... with window, softcap
    (4, 1, 10, 14, 0, False, None, None),     # bidirectional (encoder)
]


@pytest.mark.parametrize("path", ["dense", "chunked"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_matches(case, path):
    hq, hkv, sq, skv, q_offset, causal, window, softcap = case
    rng = np.random.default_rng(4)
    q, k, v = (rand(rng, 2, sq, hq, 8), rand(rng, 2, skv, hkv, 8),
               rand(rng, 2, skv, hkv, 8))
    # the chunked path: threshold below Skv, several q and kv chunks
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              softcap=softcap)
    if path == "chunked":
        kw.update(dense_threshold=4, q_chunk=3, kv_chunk=4)
    got = tattn.attention(t(q), t(k), t(v), **kw)
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **kw)
    assert got.shape == want.shape
    close(got, want)


def test_attention_chunked_equals_dense_in_the_port():
    rng = np.random.default_rng(5)
    q, k, v = rand(rng, 1, 16, 4, 8), rand(rng, 1, 16, 2, 8), \
        rand(rng, 1, 16, 2, 8)
    dense = tattn.attention(t(q), t(k), t(v))
    chunked = tattn.attention(t(q), t(k), t(v), dense_threshold=8,
                              q_chunk=4, kv_chunk=8)
    close(chunked, dense)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_casts_like_the_reference(dtype):
    """Dense: probabilities cast to v's dtype before P·V, the result in
    v's dtype; chunked: P·V in float32, the result in q's dtype."""
    rng = np.random.default_rng(6)
    q, k, v = rand(rng, 1, 8, 2, 8), rand(rng, 1, 8, 2, 8), \
        rand(rng, 1, 8, 2, 8)
    td = getattr(torch, dtype)
    for kw in ({}, dict(dense_threshold=4, q_chunk=4, kv_chunk=4)):
        got = tattn.attention(t(q, td), t(k, td), t(v, td), **kw)
        want = jattn.attention(*(jnp.asarray(a).astype(dtype)
                                 for a in (q, k, v)), **kw)
        assert str(got.dtype).endswith(str(want.dtype))
        close(got, want, TOL if dtype == "float32" else 1e-2)


def test_caches_prefill_append_and_ring_match():
    rng = np.random.default_rng(7)
    b, length, hkv, hd = 2, 6, 2, 4
    jc = jattn.init_cache(b, length, hkv, hd, jnp.float32)
    tc = tattn.init_cache(b, length, hkv, hd, torch.float32, device=CPU)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    k, v = rand(rng, b, 4, hkv, hd), rand(rng, b, 4, hkv, hd)
    jc = jattn.cache_prefill(jc, jnp.asarray(k), jnp.asarray(v), 0)
    out = tattn.cache_prefill(tc, t(k), t(v), 0)
    assert out["k"] is tc["k"]                       # written in place
    # appends past the end wrap onto slot index % length
    for index in (4, 5, 6, 7, 11):
        kn, vn = rand(rng, b, 1, hkv, hd), rand(rng, b, 1, hkv, hd)
        jc = jattn.cache_append(jc, jnp.asarray(kn), jnp.asarray(vn), index)
        tattn.cache_append(tc, t(kn), t(vn),
                           torch.tensor(index, dtype=torch.int32))
        for key in ("k", "v", "pos"):
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]))
        q = rand(rng, b, 1, 4, hd)
        for window in (None, 3):
            close(tattn.decode_attention(t(q), tc, torch.tensor(index),
                                         window=window),
                  jattn.decode_attention(jnp.asarray(q), jc, index,
                                         window=window))


def test_stacked_cache_layout():
    c = tattn.init_cache(2, 5, 1, 4, lead=(3,), device=CPU)
    assert c["k"].shape == (3, 2, 5, 1, 4) and c["k"].dtype == torch.bfloat16
    assert c["pos"].shape == (3, 2, 5) and int(c["pos"].max()) == -1


# ---------------------------------------------------------------------------
# models/gqa.py
# ---------------------------------------------------------------------------
def _attn_params(rng, cfg):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": rand(rng, d, hq, hd) / 8, "wk": rand(rng, d, hkv, hd) / 8,
         "wv": rand(rng, d, hkv, hd) / 8, "wo": rand(rng, hq, hd, d) / 8}
    if cfg.qk_norm:
        p["q_norm"] = 1 + 0.1 * rand(rng, hd)
        p["k_norm"] = 1 + 0.1 * rand(rng, hd)
    return p


@pytest.mark.parametrize("arch", ["qwen3-32b", "stablelm-1.6b", "gemma-2b"])
@pytest.mark.parametrize("cache_len,window", [(16, None), (24, None),
                                              (8, 8)])
def test_gqa_forward_cache_and_decode_match(arch, cache_len, window):
    """Projections, qk-norm, (partial) RoPE, the prefill cache (a ring of
    the last ``cache_len`` positions when it is shorter than the prompt)
    and decode steps that append to it."""
    cfg = tcfg.reduced(tcfg.get_config(arch)).replace(dtype="float32")
    rng = np.random.default_rng(8)
    p = _attn_params(rng, cfg)
    jp, tp = jax.tree.map(jnp.asarray, p), {k: t(v) for k, v in p.items()}
    x = rand(rng, 2, 12, cfg.d_model)
    jo, jc = jgqa.attn_forward(jnp.asarray(x), jp, cfg, window=window,
                               make_cache=True, cache_len=cache_len)
    to, tc = tgqa.attn_forward(t(x), tp, cfg, window=window,
                               make_cache=True, cache_len=cache_len)
    close(to, jo)
    for key in ("k", "v", "pos"):
        close(tc[key], jc[key])
    for index in (12, 13):
        xn = rand(rng, 2, 1, cfg.d_model)
        jo, jc = jgqa.attn_decode(jnp.asarray(xn), jp, cfg, jc, index,
                                  window=window)
        to, tc = tgqa.attn_decode(t(xn), tp, cfg, tc,
                                  torch.tensor(index, dtype=torch.int32),
                                  window=window)
        close(to, jo)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))


def test_cross_attention_helpers_match():
    cfg = tcfg.reduced(tcfg.get_config("mistral-nemo-12b")).replace(
        dtype="float32")
    rng = np.random.default_rng(9)
    p = _attn_params(rng, cfg)
    jp, tp = jax.tree.map(jnp.asarray, p), {k: t(v) for k, v in p.items()}
    enc, x = rand(rng, 2, 9, cfg.d_model), rand(rng, 2, 5, cfg.d_model)
    jkv = jgqa.encode_kv(jnp.asarray(enc), jp, cfg)
    tkv = tgqa.encode_kv(t(enc), tp, cfg)
    close(tkv[0], jkv[0])
    close(tkv[1], jkv[1])
    close(tgqa.cross_attn_forward(t(x), tkv, tp, cfg),
          jgqa.cross_attn_forward(jnp.asarray(x), jkv, jp, cfg))
    g = torch.Generator().manual_seed(0)
    ip = tgqa.init_cross_attn(g, cfg)
    assert {k: v[0].shape for k, v in ip.items()} == {
        k: v[0].shape for k, v in jgqa.init_cross_attn(
            jax.random.PRNGKey(0), cfg).items()}


# ---------------------------------------------------------------------------
# models/quantize.py
# ---------------------------------------------------------------------------
def _quant_tree(rng):
    return {"stacked": rand(rng, 3, 96, 5, 160),     # (layers, d, h, out)
            "mat2d": rand(rng, 1024, 1100),            # both dims >= 1024
            "norms": rand(rng, 64, 2048),              # min dim < 1024
            "small": rand(rng, 2, 16, 16),             # < MIN_QUANT_SIZE
            "ints": np.arange(1 << 17, dtype=np.int32).reshape(2, -1)}


def test_quantize_tree_exact():
    tree = _quant_tree(np.random.default_rng(10))
    jq = jquant.quantize_tree(jax.tree.map(jnp.asarray, tree))
    tq = tquant.quantize_tree({k: t(v) for k, v in tree.items()})
    assert tquant.MIN_QUANT_SIZE == jquant.MIN_QUANT_SIZE
    for key in tree:
        assert tquant.is_quantized_leaf(tq[key]) == \
            jquant.is_quantized_leaf(jq[key]), key
    for key in ("stacked", "mat2d"):
        assert tq[key]["q"].dtype == torch.int8
        np.testing.assert_array_equal(tq[key]["q"].numpy(),
                                      np.asarray(jq[key]["q"]))
        np.testing.assert_array_equal(tq[key]["scale"].numpy(),
                                      np.asarray(jq[key]["scale"]))
    assert tq["stacked"]["scale"].shape == (3, 160)
    # dequant: exact in float32, and in bf16 (same casts, one rounding)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jd, td = jquant.dequant_tree(jq, jdt), tquant.dequant_tree(tq, tdt)
        for key in tree:
            np.testing.assert_array_equal(
                td[key].float().numpy(),
                np.asarray(jnp.asarray(jd[key]).astype(jnp.float32)))
    # one layer's slice (as the layer loop hands it over) dequantizes alike
    sl = {"q": tq["stacked"]["q"][1], "scale": tq["stacked"]["scale"][1]}
    np.testing.assert_array_equal(
        tquant.dequant_tree({"w": sl}, torch.float32)["w"].numpy(),
        tquant.dequant_tree(tq, torch.float32)["stacked"][1].numpy())


def test_quantize_bf16_leaves_exact():
    rng = np.random.default_rng(11)
    w = rand(rng, 2, 256, 300)
    jq = jquant.quantize_tree({"w": jnp.asarray(w).astype(jnp.bfloat16)})
    tq = tquant.quantize_tree({"w": t(w, torch.bfloat16)})
    np.testing.assert_array_equal(tq["w"]["q"].numpy(),
                                  np.asarray(jq["w"]["q"]))
    np.testing.assert_array_equal(tq["w"]["scale"].numpy(),
                                  np.asarray(jq["w"]["scale"]))


# ---------------------------------------------------------------------------
# models/transformer.py: the LM end to end
# ---------------------------------------------------------------------------
def _tree_of(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_of(fn, v) for k, v in tree.items()}
    return fn(tree)


def _shape(a):
    return tuple(a.shape)


def _dtype(a):
    return str(a.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    """The same nesting, stacked shapes, axes, and dtypes (bf16 weights,
    float32 norms, routers, xLSTM gates and RG-LRU's ``lam``)."""
    cfg = tcfg.reduced(tcfg.get_config(arch))
    jpax = JLM(jcfg.reduced(jcfg.get_config(arch))).init(
        jax.random.PRNGKey(0))
    tpax = LM(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    assert _tree_of(_shape, tpax.params) == _tree_of(_shape, jpax.params)
    assert tpax.axes == jpax.axes
    assert _tree_of(_dtype, tpax.params) == _tree_of(_dtype, jpax.params)
    assert LM(cfg, device=CPU).param_count(tpax.params) == \
        JLM(jcfg.reduced(jcfg.get_config(arch))).param_count(jpax.params)


def test_init_wants_a_generator_on_the_lm_device():
    lm = LM(tcfg.reduced(tcfg.get_config("qwen3-32b")), device="meta")
    with pytest.raises(ValueError, match="generator on"):
        lm.init(torch.Generator())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match(arch):
    """float32: prefill logits, then four greedy decode steps, each fed
    its own argmax: logits within TOL, tokens and cache tags (or recurrent
    states) exact / within TOL."""
    cfg, jlm, jp, lm, tp = _pair(arch)
    _, jb, tb = _batches(cfg, np.random.default_rng(12), 2, 10)
    jl, jc = jlm.prefill(jp, jb, cache_len=20)
    tl, tc = lm.prefill(tp, tb, cache_len=20)
    close(tl, jl)
    assert int(tc["index"]) == int(jc["index"])
    for _ in range(4):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = tl.argmax(-1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = jlm.decode_step(jp, jc, jt)
        tl, tc = lm.decode_step(tp, tc, tt)
        close(tl, jl)
    assert int(tc["index"]) == int(jc["index"])
    for key, got in tc["groups"]["b0"].items():
        want = jc["groups"]["b0"][key]
        if key == "pos":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            close(got, want)
    if cfg.encoder is not None:
        close(tc["enc"], jc["enc"])


@pytest.mark.parametrize("prompt", [12, 13])
def test_local_ring_cache_lm_matches(prompt):
    """An attn/local pattern with a prompt longer than the window: the
    local blocks' ring caches after the prefill and after decode steps
    that wrap them, against the reference (which also evicts by slot
    ``index % window``; ROADMAP C-ref-4)."""
    cfg, jlm, jp, lm, tp = _pair("mistral-nemo-12b",
                                 block_pattern=("attn", "local"), n_layers=4,
                                 window=8)
    toks, jb, tb = _batches(cfg, np.random.default_rng(13), 2, prompt)
    jl, jc = jlm.prefill(jp, jb, cache_len=prompt + 6)
    tl, tc = lm.prefill(tp, tb, cache_len=prompt + 6)
    close(tl, jl)
    assert tc["groups"]["b1"]["k"].shape[2] == 8       # the window
    for _ in range(5):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = tl.argmax(-1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = jlm.decode_step(jp, jc, jt)
        tl, tc = lm.decode_step(tp, tc, tt)
        close(tl, jl)
        for blk in ("b0", "b1"):
            np.testing.assert_array_equal(
                tc["groups"][blk]["pos"].numpy(),
                np.asarray(jc["groups"][blk]["pos"]))


def test_ring_after_a_wrapped_prefill_evicts_like_the_reference():
    """ROADMAP C-ref-4, pinned in both packages: a prefill of 12 tokens
    into a window-8 ring keeps positions 4..11 in slots 0..7, and the
    decode step at position 12 writes slot 12 % 8 = 4, evicting position 8
    while it is still inside the window (5..12) instead of position 4."""
    cfg, jlm, jp, lm, tp = _pair("mistral-nemo-12b",
                                 block_pattern=("attn", "local"), n_layers=4,
                                 window=8)
    toks, jb, tb = _batches(cfg, np.random.default_rng(18), 1, 12)
    _, jc = jlm.prefill(jp, jb, cache_len=16)
    _, tc = lm.prefill(tp, tb, cache_len=16)
    np.testing.assert_array_equal(tc["groups"]["b1"]["pos"][0, 0].numpy(),
                                  np.arange(4, 12))
    nxt = toks[:, :1].astype(np.int32)
    _, jc = jlm.decode_step(jp, jc, jnp.asarray(nxt))
    _, tc = lm.decode_step(tp, tc, t(nxt))
    pos = tc["groups"]["b1"]["pos"][0, 0].numpy()
    np.testing.assert_array_equal(pos, np.asarray(jc["groups"]["b1"]["pos"]
                                                  )[0, 0])
    assert list(pos) == [4, 5, 6, 7, 12, 9, 10, 11]


def test_tail_group_matches():
    """A depth the pattern does not divide: the remainder runs as an
    unstacked tail group (with its own caches)."""
    cfg, jlm, jp, lm, tp = _pair("mistral-nemo-12b",
                                 block_pattern=("attn", "local"), n_layers=5,
                                 window=8)
    assert cfg.tail_pattern == ("attn",)
    _, jb, tb = _batches(cfg, np.random.default_rng(14), 2, 6)
    jl, jc = jlm.prefill(jp, jb, cache_len=10)
    tl, tc = lm.prefill(tp, tb, cache_len=10)
    close(tl, jl)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl, _ = jlm.decode_step(jp, jc, jnp.asarray(tok))
    tl, tc = lm.decode_step(tp, tc, t(tok))
    close(tl, jl)
    assert tc["tail"]["b0"]["k"].shape == (2, 10, 1, 16)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "gemma-2b",
                                  "stablelm-1.6b", "olmoe-1b-7b",
                                  "deepseek-v2-236b", "recurrentgemma-2b",
                                  "xlstm-350m", "whisper-base"])
def test_bf16_path_matches_within_bound(arch):
    """bf16 weights and activations: prefill logits and two decode steps
    fed the same tokens, within BF16_TOL; finite."""
    cfg, jlm, jp, lm, tp = _pair(arch, "bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["final_norm"]["w"].dtype == torch.float32
    toks, jb, tb = _batches(cfg, np.random.default_rng(15), 2, 12)
    jl, jc = jlm.prefill(jp, jb, cache_len=16)
    tl, tc = lm.prefill(tp, tb, cache_len=16)
    assert tl.dtype == torch.bfloat16 and torch.isfinite(tl.float()).all()
    close(tl, jl, BF16_TOL)
    for step in range(2):
        nxt = toks[:, step:step + 1].astype(np.int32)
        jl, jc = jlm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = lm.decode_step(tp, tc, t(nxt))
        close(tl, jl, BF16_TOL)


INT8_CFG = dict(n_layers=2, d_model=1024, n_heads=8, n_kv_heads=2,
                head_dim=64, d_ff=512, vocab_size=1024, window=None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_path_matches_reference_int8(dtype):
    """quantize_tree of the same weights in both packages, then prefill and
    decode on the int8 tree: the layer leaves, the embedding table and the
    untied head all quantized (d_model 1024 takes the 2D leaves too)."""
    cfg, jlm, jp, lm, tp = _pair("mistral-nemo-12b", dtype, **INT8_CFG)
    jq, tq = jquant.quantize_tree(jp), tquant.quantize_tree(tp)
    for name in ("embed", "lm_head"):
        assert tquant.is_quantized_leaf(tq[name])
        np.testing.assert_array_equal(tq[name]["q"].numpy(),
                                      np.asarray(jq[name]["q"]))
    assert tquant.is_quantized_leaf(tq["groups"]["b0"]["mlp"]["w_up"])
    # the reference's int8 tree carried across as it is
    tq2 = lm_params_from_numpy(to_np(jq), cfg, device=CPU)
    np.testing.assert_array_equal(
        tq2["groups"]["b0"]["attn"]["wq"]["q"].numpy(),
        tq["groups"]["b0"]["attn"]["wq"]["q"].numpy())
    tol = TOL if dtype == "float32" else BF16_TOL
    toks, jb, tb = _batches(cfg, np.random.default_rng(16), 2, 8)
    jl, jc = jlm.prefill(jq, jb, cache_len=12)
    tl, tc = lm.prefill(tq, tb, cache_len=12)
    close(tl, jl, tol)
    nxt = toks[:, :1].astype(np.int32)
    jl, _ = jlm.decode_step(jq, jc, jnp.asarray(nxt))
    tl, _ = lm.decode_step(tq, tc, t(nxt))
    close(tl, jl, tol)


def test_int8_decode_close_to_bf16():
    """The reference's criterion (tests/test_quantize.py): quantized
    serving decode correlates > 0.98 with the unquantized path."""
    cfg = tcfg.reduced(tcfg.get_config("qwen3-32b")).replace(**INT8_CFG)
    lm = LM(cfg, device=CPU)
    params = lm.init(torch.Generator().manual_seed(0)).params
    toks = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8)))
    _, caches = lm.prefill(params, {"tokens": toks[:, :7]}, cache_len=8)
    ref, _ = lm.decode_step(params, caches, toks[:, 7:])
    qparams = tquant.quantize_tree(params)
    _, caches_q = lm.prefill(qparams, {"tokens": toks[:, :7]}, cache_len=8)
    got, _ = lm.decode_step(qparams, caches_q, toks[:, 7:])
    a, b = got.float().numpy().ravel(), ref.float().numpy().ravel()
    assert np.corrcoef(a, b)[0, 1] > 0.98


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """The reference's check on the port alone (bf16, its bound): the
    cached incremental path and the parallel path agree."""
    cfg = tcfg.reduced(tcfg.get_config(arch))
    lm = LM(cfg, device=CPU)
    params = lm.init(torch.Generator().manual_seed(1)).params
    rng = np.random.default_rng(3)
    s = 12
    _, _, tb = _batches(cfg, rng, 1, s)
    full = {**tb}
    part = {**tb, "tokens": tb["tokens"][:, :s - 1]}
    n_extra = tb["patches"].shape[1] if "patches" in tb else 0
    full_logits, _ = lm.prefill(params, full, cache_len=s + n_extra)
    _, caches = lm.prefill(params, part, cache_len=s + n_extra)
    inc_logits, _ = lm.decode_step(params, caches, tb["tokens"][:, s - 1:])
    close(inc_logits, full_logits.float().numpy(), BF16_TOL)
    assert int(inc_logits.argmax()) == int(full_logits.argmax())


def test_steps_drive_the_lm_on_one_device():
    cfg, jlm, jp, lm, tp = _pair("qwen3-32b")
    assert make_ctx(None).mesh is None
    from jax.sharding import AbstractMesh as JMesh
    from repro.launch.steps import make_ctx as j_make_ctx
    from repro_torch.launch.mesh import AbstractMesh
    for use_tp in (True, False):
        for sizes, names in (((2, 2), ("data", "model")),
                             ((2, 4, 2), ("pod", "data", "model"))):
            want = j_make_ctx(JMesh(sizes, names),
                              cfg.replace(use_tp=use_tp))
            got = make_ctx(AbstractMesh(sizes, names),
                           cfg.replace(use_tp=use_tp))
            assert (got.data_axes, got.model_axis, got.fsdp) == (
                want.data_axes, want.model_axis, want.fsdp)
    prefill, decode = make_prefill_step(lm, None, 12), make_decode_step(lm,
                                                                        None)
    _, jb, tb = _batches(cfg, np.random.default_rng(17), 2, 8)
    tl, tc = prefill(tp, tb)
    jl, jc = jlm.prefill(jp, jb, cache_len=12)
    close(tl, jl)
    tok = tl.argmax(-1)
    tl, tc = decode(tp, tc, tok)
    jl, jc = jlm.decode_step(jp, jc, jnp.asarray(tok.numpy()))
    close(tl, jl)
    assert tc["groups"]["b0"]["k"].shape[2] == 12
