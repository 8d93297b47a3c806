"""The port's MoE, MLA, RG-LRU, xLSTM and enc-dec blocks against the JAX
package's, on the CPU.

The same seeded NumPy inputs and weights go through both packages (the
reference's init, carried across as float32 NumPy).  Tolerances: float32
within ``TOL`` = 1e-5 (the LM tests' bound: the same arithmetic in
another order) unless a test states otherwise; integer results (routing
indices, drops, cache position tags) exactly.  ``rglru_scan`` runs a
doubling scan where the reference runs ``jax.lax.associative_scan``; the
two orders of the same float32 products, after gates whose sigmoid /
softplus / sqrt already differ by up to 6e-7 at S = 1, differ by up to
1.4e-6 at S = 64 on states up to 2.9 (3.6e-6 at S = 512): ``SCAN_TOL`` =
2e-6 (as rtol and atol) covers S <= 64, the lengths tested here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jcfg
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import quantize as jquant
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro.models.common import split_tree as jsplit
from repro.models.transformer import LM as JLM
from repro.models.transformer import ParallelCtx as JCtx

import repro_torch.configs as tcfg
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models import quantize as tquant
from repro_torch.models import rglru as trglru
from repro_torch.models import xlstm as txlstm
from repro_torch.models.transformer import LM, lm_params_from_numpy

TOL = 1e-5
SCAN_TOL = 2e-6
BF16_TOL = 0.15
CPU = torch.device("cpu")


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
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    def one(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return np.asarray(a.astype(jnp.float32))
        return np.asarray(a)
    return jax.tree.map(one, tree)


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cfg(arch, **over):
    return (tcfg.reduced(tcfg.get_config(arch)).replace(dtype="float32",
                                                        **over),
            jcfg.reduced(jcfg.get_config(arch)).replace(dtype="float32",
                                                        **over))


def _params(init, rcfg, seed=0):
    """One block's reference params (float32) and the same as tensors."""
    jp = to_np(jsplit(init(jax.random.PRNGKey(seed), rcfg)).params)
    return (jax.tree.map(jnp.asarray, jp),
            jax.tree.map(lambda a: t(a), jp))


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ties", [False, True])
def test_route_matches(ties):
    """Indices equal (planted ties: the lower index first, as
    ``jax.lax.top_k``), gates within 1e-6, the aux losses within 1e-5."""
    cfg, rcfg = _cfg("olmoe-1b-7b")
    m = cfg.moe.__class__(n_experts=8, top_k=3, d_expert=32)
    rng = np.random.default_rng(0)
    x = rand(rng, 24, cfg.d_model)
    w = rand(rng, cfg.d_model, 8) / 8
    if ties:   # duplicate router columns: equal probabilities per token
        w[:, 5] = w[:, 2]
        w[:, 7] = w[:, 2]
        w[:, 3] = w[:, 1]
    ji, jg, ja = jmoe._route(jnp.asarray(x), jnp.asarray(w), m)
    ti, tg, ta = tmoe._route(t(x), t(w), m)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tg, jg, 1e-6)
    close(ta, ja)
    if ties:   # the tied pairs were chosen together somewhere, lower first
        both = (ti == 2).any(1) & (ti == 5).any(1)
        assert bool(both.any())
        rows = ti[both].tolist()
        assert all(r.index(2) < r.index(5) for r in rows)
    _, _, none = tmoe._route(t(x), t(w), m, aux=False)
    assert none is None


def _reference_drops(idx, n_experts, capacity):
    """The reference's capacity rule in NumPy: within each expert, the
    assignments in (token, k) order past ``capacity`` drop."""
    seen, drops = np.zeros(n_experts, int), 0
    for e in np.asarray(idx).reshape(-1):
        seen[e] += 1
        drops += seen[e] > capacity
    return drops


@pytest.mark.parametrize("skew", [False, True])
def test_dispatch_compute_matches_at_capacity_factor(skew):
    """The config's capacity factor 1.25: the same assignments dropped
    (a skewed router overfills experts), outputs within 1e-5 (a dropped
    assignment would move its token's row by far more)."""
    cfg, rcfg = _cfg("olmoe-1b-7b")
    m = cfg.moe.__class__(n_experts=8, top_k=2, d_expert=32,
                          capacity_factor=1.25)
    jp, tp = _params(jmoe.init_moe, rcfg.replace(moe=m))
    rng = np.random.default_rng(1)
    x = rand(rng, 20, cfg.d_model)
    if skew:   # near-identical tokens all prefer the same experts
        x = rand(rng, 1, cfg.d_model) + 0.05 * x
    ji, jg, _ = jmoe._route(jnp.asarray(x), jp["router"], m)
    cap = int(np.ceil(20 * m.top_k * m.capacity_factor / m.n_experts))
    drops = _reference_drops(ji, m.n_experts, cap)
    if skew:   # at 1.25 a few drop anyway (2 of 40 unskewed); skew: most
        assert drops > 20
    want = jmoe._dispatch_compute(jnp.asarray(x), ji, jg, jp["w_gate"],
                                  jp["w_up"], jp["w_down"], 0, m.n_experts,
                                  cap)
    got = tmoe._dispatch_compute(t(x), t(ji), t(jg), tp["w_gate"],
                                 tp["w_up"], tp["w_down"], 0, m.n_experts,
                                 cap)
    close(got, want)
    # a token with every assignment dropped has an all-zero row in both
    zero = np.abs(np.asarray(want)).sum(1) == 0
    np.testing.assert_array_equal(got.abs().sum(1).numpy() == 0, zero)


def test_dispatch_keeps_capacity_one_per_expert():
    """olmoe's routing shape at a decode step of batch 4 (64 experts, top
    8, factor 1.25): capacity 1 per expert, the sentinel slot absorbing
    every drop, the buffer smaller than the assignments (n_gather 32 of
    64 slots)."""
    cfg, rcfg = _cfg("olmoe-1b-7b")
    m = cfg.moe.__class__(n_experts=64, top_k=8, d_expert=8)
    jp, tp = _params(jmoe.init_moe, rcfg.replace(moe=m))
    x = rand(np.random.default_rng(2), 4, cfg.d_model)
    ji, jg, _ = jmoe._route(jnp.asarray(x), jp["router"], m)
    cap = int(np.ceil(4 * 8 * m.capacity_factor / 64))
    assert cap == 1 and _reference_drops(ji, 64, cap) > 0
    want = jmoe._dispatch_compute(jnp.asarray(x), ji, jg, jp["w_gate"],
                                  jp["w_up"], jp["w_down"], 0, 64, cap)
    got = tmoe._dispatch_compute(t(x), t(ji), t(jg), tp["w_gate"],
                                 tp["w_up"], tp["w_down"], 0, 64, cap)
    close(got, want)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_moe_forward_matches(arch):
    """The EP-free ``moe_forward`` (deepseek's with its shared expert):
    outputs within 1e-5, the aux loss within 1e-5."""
    cfg, rcfg = _cfg(arch)
    jp, tp = _params(jmoe.init_moe, rcfg)
    assert ("shared" in tp) == bool(cfg.moe.n_shared)
    x = rand(np.random.default_rng(3), 2, 7, cfg.d_model)
    jy, ja = jmoe.moe_forward(jnp.asarray(x), jp, rcfg)
    ty, ta = tmoe.moe_forward(t(x), tp, cfg)
    close(ty, jy)
    close(ta, ja)
    ty2, none = tmoe.moe_forward(t(x), tp, cfg, aux=False)
    assert none is None and torch.equal(ty2, ty)


def test_moe_mesh_raises_naming_a12f():
    """Expert parallelism is ported (the mesh runs are held against the
    reference in ``test_torch_mesh.py``): a model axis that does not divide
    the experts fails the reference's assertion before any collective, and
    a trivial mesh runs the local path, equal to ``mesh=None``."""
    cfg, _ = _cfg("olmoe-1b-7b")
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, device=CPU)
    tp = {k: (v[0] if isinstance(v, tuple) else v) for k, v in tp.items()}

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 3}

    x = torch.randn(1, 2, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    with pytest.raises(AssertionError):
        tmoe.moe_forward(x, tp, cfg, Mesh())
    Mesh.shape = {"data": 1, "model": 1}    # a trivial mesh runs locally
    y, aux = tmoe.moe_forward(x, tp, cfg, Mesh())
    y0, aux0 = tmoe.moe_forward(x, tp, cfg)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


# ---------------------------------------------------------------------------
# models/mla.py
# ---------------------------------------------------------------------------
def test_mla_forward_cache_and_absorbed_decode_match():
    cfg, rcfg = _cfg("deepseek-v2-236b")
    jp, tp = _params(jmla.init_mla, rcfg)
    rng = np.random.default_rng(4)
    x = rand(rng, 2, 9, cfg.d_model)
    jo, jc = jmla.mla_forward(jnp.asarray(x), jp, rcfg, make_cache=True,
                              cache_len=12)
    to, tc = tmla.mla_forward(t(x), tp, cfg, make_cache=True, cache_len=12)
    close(to, jo)
    for key in ("c_kv", "k_rope"):
        close(tc[key], jc[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for index in (9, 10, 11):
        xn = rand(rng, 2, 1, cfg.d_model)
        jo, jc = jmla.mla_decode(jnp.asarray(xn), jp, rcfg, jc, index)
        to, tc = tmla.mla_decode(t(xn), tp, cfg, tc,
                                 torch.tensor(index, dtype=torch.int32))
        close(to, jo)
        for key in ("c_kv", "k_rope"):
            close(tc[key], jc[key])
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))


def test_mla_cache_is_latent_and_written_in_place():
    cfg, _ = _cfg("deepseek-v2-236b")
    c = tmla.init_cache(2, 6, cfg, torch.float32, lead=(3,), device=CPU)
    assert c["c_kv"].shape == (3, 2, 6, cfg.mla.kv_lora)
    assert c["k_rope"].shape == (3, 2, 6, cfg.mla.rope_dim)
    assert int(c["pos"].max()) == -1
    tp = _params(jmla.init_mla, _cfg("deepseek-v2-236b")[1])[1]
    view = {k: v[1] for k, v in c.items()}
    x = torch.randn(2, 4, cfg.d_model)
    _, out = tmla.mla_forward(x, tp, cfg, make_cache=True, cache=view)
    assert out is view and c["pos"][1, 0].tolist() == [0, 1, 2, 3, -1, -1]
    tmla.mla_decode(x[:, :1], tp, cfg, view, torch.tensor(4))
    assert c["pos"][1, 0].tolist() == [0, 1, 2, 3, 4, -1]


# ---------------------------------------------------------------------------
# models/rglru.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 7, 64])
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_scan_matches_associative_scan(s, carried):
    cfg, rcfg = _cfg("recurrentgemma-2b")
    jp, tp = _params(jrglru.init_rglru, rcfg)
    rng = np.random.default_rng(5)
    xc = rand(rng, 2, s, cfg.lru_dim)
    h0 = rand(rng, 2, cfg.lru_dim) if carried else None
    jh, jl = jrglru.rglru_scan(jnp.asarray(xc), jp,
                               None if h0 is None else jnp.asarray(h0))
    th, tl = trglru.rglru_scan(t(xc), tp, None if h0 is None else t(h0))
    assert th.dtype == torch.float32 and th.shape == (2, s, cfg.lru_dim)
    close(th, jh, SCAN_TOL)
    close(tl, jl, SCAN_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    rng = np.random.default_rng(6)
    x, w, b = rand(rng, 2, 5, 16), rand(rng, 4, 16), rand(rng, 16)
    st = rand(rng, 2, 3, 16) if with_state else None
    jo, js = jrglru._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if st is None else jnp.asarray(st))
    to, ts = trglru._causal_conv(t(x), t(w), t(b),
                                 None if st is None else t(st))
    close(to, jo)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_rglru_block_forward_and_decode_match():
    cfg, rcfg = _cfg("recurrentgemma-2b")
    jp, tp = _params(jrglru.init_rglru, rcfg)
    assert tp["lam"].dtype == torch.float32
    rng = np.random.default_rng(7)
    x = rand(rng, 2, 10, cfg.d_model)
    jy, js = jrglru.rglru_block_forward(jnp.asarray(x), jp, rcfg)
    ty, ts = trglru.rglru_block_forward(t(x), tp, cfg)
    close(ty, jy)
    for key in ("conv", "h"):
        close(ts[key], js[key], SCAN_TOL)
    for _ in range(3):
        xn = rand(rng, 2, 1, cfg.d_model)
        jy, js = jrglru.rglru_block_decode(jnp.asarray(xn), jp, rcfg, js)
        ty, ts = trglru.rglru_block_decode(t(xn), tp, cfg, ts)
        close(ty, jy)
        close(ts["h"], js["h"], SCAN_TOL)
    st = trglru.init_state(3, cfg, torch.bfloat16, lead=(2,), device=CPU)
    js0 = jrglru.init_state(3, rcfg, jnp.bfloat16)
    assert st["conv"].shape[1:] == js0["conv"].shape
    assert st["conv"].dtype == torch.bfloat16 and st["h"].dtype == \
        torch.float32


# ---------------------------------------------------------------------------
# models/xlstm.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_chunks", [1, 2])
def test_mlstm_chunk_forward_and_decode_match(n_chunks):
    cfg, rcfg = _cfg("xlstm-350m")
    jp, tp = _params(jxlstm.init_mlstm, rcfg)
    for name in ("w_i", "w_f", "b_i", "b_f"):
        assert tp[name].dtype == torch.float32
    rng = np.random.default_rng(8)
    x = rand(rng, 2, 6 * n_chunks, cfg.d_model)
    jy, js = jxlstm.mlstm_chunk_forward(jnp.asarray(x), jp, rcfg, chunk=6)
    ty, ts = txlstm.mlstm_chunk_forward(t(x), tp, cfg, chunk=6)
    close(ty, jy)
    for key in ("c", "n", "m"):
        close(ts[key], js[key])
    for _ in range(2):
        xn = rand(rng, 2, 1, cfg.d_model)
        jy, js = jxlstm.mlstm_decode(jnp.asarray(xn), jp, rcfg, js)
        ty, ts = txlstm.mlstm_decode(t(xn), tp, cfg, ts)
        close(ty, jy)
        for key in ("c", "n", "m"):
            close(ts[key], js[key])
    with pytest.raises(ValueError, match="multiple of the chunk"):
        txlstm.mlstm_chunk_forward(t(rand(rng, 2, 7, cfg.d_model)), tp, cfg,
                                   chunk=6)


def test_slstm_forward_and_decode_match():
    cfg, rcfg = _cfg("xlstm-350m")
    jp, tp = _params(jxlstm.init_slstm, rcfg)
    assert tp["b_f"].dtype == torch.float32
    rng = np.random.default_rng(9)
    x = rand(rng, 2, 9, cfg.d_model)
    jy, js = jxlstm.slstm_forward(jnp.asarray(x), jp, rcfg)
    ty, ts = txlstm.slstm_forward(t(x), tp, cfg)
    close(ty, jy)
    for key in ("c", "n", "h", "m"):
        close(ts[key], js[key])
    for _ in range(2):
        xn = rand(rng, 2, 1, cfg.d_model)
        jy, js = jxlstm.slstm_decode(jnp.asarray(xn), jp, rcfg, js)
        ty, ts = txlstm.slstm_decode(t(xn), tp, cfg, ts)
        close(ty, jy)
        for key in ("c", "n", "h", "m"):
            close(ts[key], js[key])


# ---------------------------------------------------------------------------
# the enc-dec stack (whisper)
# ---------------------------------------------------------------------------
def _lm_pair(arch, dtype="float32", **over):
    cfg = tcfg.reduced(tcfg.get_config(arch)).replace(dtype=dtype, **over)
    rcfg = jcfg.reduced(jcfg.get_config(arch)).replace(dtype=dtype, **over)
    jlm = JLM(rcfg)
    jp = jlm.init(jax.random.PRNGKey(1)).params
    lm = LM(cfg, device=CPU)
    return cfg, jlm, jp, lm, lm_params_from_numpy(to_np(jp), cfg, device=CPU)


def test_encoder_and_encdec_forward_match():
    """``_encode`` over stub frames, then the decoder with a
    cross-attention after each group (the reference's
    ``_encdec_forward``), the caches filled alike."""
    cfg, jlm, jp, lm, tp = _lm_pair("whisper-base")
    rng = np.random.default_rng(10)
    frames = rand(rng, 2, cfg.encoder.seq_len, cfg.d_model)
    jenc = jlm._encode(jp, jnp.asarray(frames), JCtx())
    tenc = lm._encode(tp, t(frames))
    close(tenc, jenc)
    toks = rng.integers(0, cfg.vocab_size, (2, 6))
    jx = jlm._embed(jp, jnp.asarray(toks))
    jy, jc, _ = jlm._encdec_forward(jp, jx, jenc, JCtx(), make_cache=True,
                                    cache_len=8)
    caches = lm.init_caches(2, 8)
    ty = lm._backbone(tp, lm._embed(tp, t(toks)), caches, 8, None, tenc)
    close(ty, jy)
    close(caches["groups"]["b0"]["k"], jc["b0"]["k"])
    assert tp["groups"]["xattn"]["wq"].shape[0] == cfg.n_groups


# ---------------------------------------------------------------------------
# lm_params_from_numpy: each leaf at the reference's dtype
# ---------------------------------------------------------------------------
def _dtypes(tree):
    if isinstance(tree, dict):
        return {k: _dtypes(v) for k, v in tree.items()}
    return str(tree.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "xlstm-350m",
                                  "recurrentgemma-2b", "deepseek-v2-236b",
                                  "whisper-base"])
def test_params_carry_each_leaf_at_the_reference_dtype(arch):
    """bf16 models keep their float32 leaves float32: the MoE router,
    mLSTM's w_i/w_f/b_i/b_f, sLSTM's b_f, RG-LRU's lam, every norm."""
    cfg, jlm, jp, lm, tp = _lm_pair(arch, "bfloat16")
    assert _dtypes(tp) == jax.tree.map(lambda a: str(a.dtype), jp)
    float32 = {"olmoe-1b-7b": [("moe", "router")],
               "deepseek-v2-236b": [("moe", "router")],
               "xlstm-350m": [("mixer", k) for k in ("w_i", "w_f", "b_i",
                                                     "b_f")],
               "recurrentgemma-2b": [("mixer", "lam")],
               "whisper-base": []}[arch]
    for sub, leaf in float32:
        assert tp["groups"]["b0"][sub][leaf].dtype == torch.float32
    if arch == "xlstm-350m":
        assert tp["groups"]["b3"]["mixer"]["b_f"].dtype == torch.float32
    with pytest.raises(KeyError):
        lm_params_from_numpy({"no_such_leaf": np.zeros(2, np.float32)}, cfg,
                             device=CPU)


# ---------------------------------------------------------------------------
# int8 serving of a reduced MoE
# ---------------------------------------------------------------------------
MOE_INT8 = dict(d_model=256, n_heads=4, n_kv_heads=4, head_dim=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_int8_quantization_exact_and_served_alike(dtype):
    """quantize_tree of the same olmoe weights in both packages: the 4-D
    expert leaves with one scale per (layer, out channel), bit for bit;
    prefill and a decode step from the int8 trees within TOL (float32) or
    BF16_TOL, with the reference's own int8 tree carried as it is."""
    m = tcfg.get_config("olmoe-1b-7b").moe.__class__(
        n_experts=8, top_k=2, d_expert=64, capacity_factor=8.0)
    cfg, jlm, jp, lm, tp = _lm_pair("olmoe-1b-7b", dtype, moe=m, **MOE_INT8)
    jq, tq = jquant.quantize_tree(jp), tquant.quantize_tree(tp)
    for name in ("w_gate", "w_up", "w_down"):
        tl, jl_ = tq["groups"]["b0"]["moe"][name], jq["groups"]["b0"]["moe"][
            name]
        assert tquant.is_quantized_leaf(tl) and tl["q"].ndim == 4
        assert tl["scale"].shape == (cfg.n_groups, tl["q"].shape[-1])
        np.testing.assert_array_equal(tl["q"].numpy(), np.asarray(jl_["q"]))
        np.testing.assert_array_equal(tl["scale"].numpy(),
                                      np.asarray(jl_["scale"]))
    carried = lm_params_from_numpy(to_np(jq), cfg, device=CPU)
    assert torch.equal(carried["groups"]["b0"]["moe"]["w_up"]["q"],
                       tq["groups"]["b0"]["moe"]["w_up"]["q"])
    tol = TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, 8))
    jl, jc = jlm.prefill(jq, {"tokens": jnp.asarray(toks)}, cache_len=10)
    tl, tc = lm.prefill(tq, {"tokens": t(toks)}, cache_len=10)
    close(tl, jl, tol)
    nxt = toks[:, :1].astype(np.int32)
    jl, _ = jlm.decode_step(jq, jc, jnp.asarray(nxt))
    tl, _ = lm.decode_step(tq, tc, t(nxt))
    close(tl, jl, tol)
