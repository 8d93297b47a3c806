"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

mLSTM recurrence per head (exp gating with max-stabilizer m):

    m_t  = max(f~_t + m_{t-1}, i~_t)
    f'   = exp(f~_t + m_{t-1} - m_t);  i' = exp(i~_t - m_t)
    C_t  = f' C_{t-1} + i' k_t v_t^T          (matrix memory, hd x hd)
    n_t  = f' n_{t-1} + i' k_t
    h_t  = (q_t^T C_t) / max(|q_t^T n_t|, exp(-m_t))

Prefill runs the *chunkwise* form: within a chunk the output is an
attention-like masked product with gate matrix D, across chunks the (C, n,
m) state is carried recurrently (a Python loop over chunks for the
reference's ``lax.scan``) — O(S * L) work instead of O(S^2).  Decode is
the plain O(1) step.  sLSTM has recurrent weights on h so it is
inherently sequential: a Python loop over time, as the reference's
``lax.scan`` (about 20 launches per step on the card).

The gate projections ``w_i``/``w_f`` and biases ``b_i``/``b_f`` stay
float32 in every model dtype, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.common import (apply_norm, dense_init, norm_init,
                                       zeros_init)
from repro_torch.parallel import act

__all__ = ["NEG", "init_mlstm", "mlstm_chunk_forward", "mlstm_decode",
           "init_mlstm_state", "init_slstm", "slstm_forward", "slstm_decode",
           "init_slstm_state"]

NEG = -1e30


def _log_sigmoid(x):
    return -torch.logaddexp(-x, torch.zeros_like(x))   # -jax.nn.softplus(-x)


def _full(shape, value, *, lead, device, axes):
    return (torch.full(tuple(lead) + shape, value, dtype=torch.float32,
                       device=device), ("layers",) * len(lead) + axes)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm(key, cfg, dtype=torch.float32, *, lead=(), device=None):
    d, h = cfg.d_model, cfg.n_heads
    hd = cfg.head_dim
    kw = dict(lead=lead, device=device)
    dev = key.device if device is None else device
    return {
        "wq": dense_init(key, (d, h, hd), ("embed", "heads", None), 0, dtype,
                         **kw),
        "wk": dense_init(key, (d, h, hd), ("embed", "heads", None), 0, dtype,
                         **kw),
        "wv": dense_init(key, (d, h, hd), ("embed", "heads", None), 0, dtype,
                         **kw),
        "w_i": dense_init(key, (d, h), ("embed", "heads"), 0, torch.float32,
                          **kw),
        "w_f": dense_init(key, (d, h), ("embed", "heads"), 0, torch.float32,
                          **kw),
        "b_i": zeros_init((h,), ("heads",), lead=lead, device=dev),
        "b_f": _full((h,), 3.0, lead=lead, device=dev,
                     axes=("heads",)),                     # open forget
        "w_o": dense_init(key, (d, h, hd), ("embed", "heads", None), 0, dtype,
                          **kw),
        "norm": norm_init(h * hd, lead=lead, device=dev),
        "w_out": dense_init(key, (h, hd, d), ("heads", None, "embed"),
                            (0, 1), dtype, **kw),
    }


def _mlstm_proj(x, p):
    hd = p["wq"].shape[-1]
    # / np.sqrt(hd): a strongly typed float32 scalar in the reference
    inv = float(np.float32(np.sqrt(hd)))
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype)) / inv
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype)) / inv
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    it = (torch.einsum("bsd,dh->bsh", x.float(), p["w_i"].float())
          + p["b_i"])
    ft = (torch.einsum("bsd,dh->bsh", x.float(), p["w_f"].float())
          + p["b_f"])
    ft = _log_sigmoid(ft)                # log f in (-inf, 0)
    og = torch.sigmoid(torch.einsum("bsd,dhk->bshk", x,
                                    p["w_o"].to(x.dtype)))
    return q, k, v, it, ft, og


def _mlstm_chunk(carry, qc, kc, vc, ic, fc):
    """One chunk of the chunkwise form (the reference's ``chunk_step``)."""
    c0, n0, m0 = carry                       # (B,H,hd,hd),(B,H,hd),(B,H)
    l = qc.shape[1]
    g = torch.cumsum(fc, dim=1)              # (B,L,H) cumulative log f
    # stabilizers: intra source term a_s = i~_s - g_s ; inter term m0
    a = ic - g
    a_run = torch.cummax(a, dim=1).values    # running max over s<=t
    m_t = torch.maximum(g + m0[:, None, :], g + a_run)
    # inter-chunk: exp(g_t + m0 - m_t) * (q C0, q n0)
    inter_w = torch.exp(g + m0[:, None, :] - m_t)
    q32 = qc.float()
    k32, v32 = kc.float(), vc.float()
    inter_h = torch.einsum("blhk,bhkj->blhj", q32, c0) * inter_w[..., None]
    inter_n = torch.einsum("blhk,bhk->blh", q32, n0) * inter_w
    # intra-chunk masked gate matrix D[t,s] = exp(g_t - g_s + i_s - m_t)
    logd = (g[:, :, None, :] - g[:, None, :, :]
            + ic[:, None, :, :] - m_t[:, :, None, :])   # (B,L,L,H) t,s
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=qc.device))
    logd = torch.where(mask[None, :, :, None], logd, NEG)
    dmat = torch.exp(logd)
    scores = torch.einsum("bthk,bshk->btsh", q32, k32)
    w = scores * dmat
    intra_h = torch.einsum("btsh,bshj->bthj", w, v32)
    intra_n = w.sum(dim=2)                               # (B,L,H)
    denom = torch.maximum(torch.abs(inter_n + intra_n), torch.exp(-m_t))
    h_out = (inter_h + intra_h) / denom[..., None]       # (B,L,H,hd)
    # chunk-end state
    g_l = g[:, -1, :]                                    # (B,H)
    m_end = torch.maximum(g_l + m0, g_l + a_run[:, -1, :])
    src = torch.exp(g_l[:, None, :] - g + ic - m_end[:, None, :])
    decay = torch.exp(g_l + m0 - m_end)
    c_new = (decay[..., None, None] * c0
             + torch.einsum("blhk,blhj,blh->bhkj", k32, v32, src))
    n_new = decay[..., None] * n0 + torch.einsum("blhk,blh->bhk", k32, src)
    return (c_new, n_new, m_end), h_out


def _mlstm_chunks(carry, q, k, v, it, ft, l: int):
    """The chunk loop over the sequence: ((B,S,H,hd) outputs, carry)."""
    hs = []
    for c in range(q.shape[1] // l):
        sl = slice(c * l, (c + 1) * l)
        carry, h_out = _mlstm_chunk(carry, q[:, sl], k[:, sl], v[:, sl],
                                    it[:, sl], ft[:, sl])
        hs.append(h_out)
    return torch.cat(hs, dim=1), carry


def mlstm_chunk_forward(x, p, cfg, state=None, chunk: int = 256):
    """Chunkwise-parallel mLSTM over a sequence.

    x: (B, S, d) with S % chunk == 0 (or S < chunk: single chunk).
    state: None or dict(c (B,H,hd,hd), n (B,H,hd), m (B,H)).
    Returns (y, new_state).
    """
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {l}")
    q, k, v, it, ft, og = _mlstm_proj(x, p)
    if state is None:
        state = init_mlstm_state(b, cfg, device=x.device)
    carry = (state["c"], state["n"], state["m"])
    ctx = act.current()
    if ctx is not None and act.is_dtensor(q):
        # a mesh: the chunk loop per rank, on its batch shard and heads
        dp, hm = act.data_entry(ctx, b), act.model_entry(ctx, h)
        mesh = ctx["mesh"]
        pl = {n: act.region(ctx, n, d0=dp, d2=hm) for n in (3, 4)}
        st = [act.region(ctx, t.ndim, d0=dp, d1=hm) for t in carry]
        loc = [act.to_local(t, mesh, pl[t.ndim])
               for t in (q, k, v, it, ft)]
        carry_l = tuple(act.to_local(t, mesh, p_) for t, p_ in zip(carry,
                                                                    st))
        hs, carry_l = _mlstm_chunks(carry_l, *loc, l)
        hs = act.from_local(hs, mesh, pl[4])
        carry = tuple(act.from_local(t, mesh, p_)
                      for t, p_ in zip(carry_l, st))
    else:
        hs, carry = _mlstm_chunks(carry, q, k, v, it, ft, l)
    hs = hs.to(x.dtype) * og
    flat = apply_norm(hs.reshape(b, s, h * hd), p["norm"])
    y = torch.einsum("bshk,hkd->bsd", flat.reshape(b, s, h, hd),
                     p["w_out"].to(x.dtype))
    c, n, m = carry
    return y, {"c": c, "n": n, "m": m}


def mlstm_decode(x, p, cfg, state):
    """O(1) one-token step. x: (B, 1, d)."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v, it, ft, og = _mlstm_proj(x, p)
    q, k, v, og = (a[:, 0] for a in (q, k, v, og))       # (B,H,hd)
    it, ft = it[:, 0], ft[:, 0]                           # (B,H)
    m_new = torch.maximum(ft + state["m"], it)
    fp = torch.exp(ft + state["m"] - m_new)[..., None]
    ip = torch.exp(it - m_new)[..., None]
    k32, v32, q32 = (a.float() for a in (k, v, q))
    c = fp[..., None] * state["c"] + ip[..., None] * (k32[..., :, None]
                                                      * v32[..., None, :])
    n = fp * state["n"] + ip * k32
    num = torch.einsum("bhk,bhkj->bhj", q32, c)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q32, n)),
                        torch.exp(-m_new))
    hvec = (num / den[..., None]).to(x.dtype) * og
    flat = apply_norm(hvec.reshape(b, 1, h * hd), p["norm"])
    y = torch.einsum("bshk,hkd->bsd", flat.reshape(b, 1, h, hd),
                     p["w_out"].to(x.dtype))
    return y, {"c": c, "n": n, "m": m_new}


def init_mlstm_state(batch, cfg, *, lead=(), device=None):
    h, hd = cfg.n_heads, cfg.head_dim
    lead, dev = tuple(lead), resolve_device(device)
    z = lambda *shape: torch.zeros(lead + (batch,) + shape,
                                   dtype=torch.float32, device=dev)
    return {"c": z(h, hd, hd), "n": z(h, hd), "m": z(h)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm(key, cfg, dtype=torch.float32, *, lead=(), device=None):
    d, h = cfg.d_model, cfg.n_heads
    hd = cfg.head_dim
    kw = dict(lead=lead, device=device)
    dev = key.device if device is None else device
    gate = lambda: dense_init(key, (d, h, hd), ("embed", "heads", None), 0,
                              dtype, **kw)
    rec = lambda: dense_init(key, (h, hd, hd), ("heads", None, None), (1,),
                             dtype, scale=0.5, **kw)
    return {
        "wz": gate(), "wi": gate(), "wf": gate(), "wo": gate(),
        "rz": rec(), "ri": rec(), "rf": rec(), "ro": rec(),
        "b_f": _full((h, hd), 3.0, lead=lead, device=dev,
                     axes=("heads", None)),
        "norm": norm_init(h * hd, lead=lead, device=dev),
        "w_out": dense_init(key, (h, hd, d), ("heads", None, "embed"),
                            (0, 1), dtype, **kw),
    }


def _slstm_step(p, carry, xs):
    c0, n0, h0, m0 = carry                   # (B,H,hd) x3, m (B,H,hd)
    xz, xi, xf, xo = xs                      # (B,H,hd) pre-projections
    r = lambda w: torch.einsum("bhk,hkj->bhj", h0, w.to(h0.dtype))
    z = torch.tanh(xz + r(p["rz"]))
    it = (xi + r(p["ri"])).float()
    ft = (xf + r(p["rf"]) + p["b_f"]).float()
    ft = _log_sigmoid(ft)
    o = torch.sigmoid(xo + r(p["ro"]))
    m1 = torch.maximum(ft + m0, it)
    ip = torch.exp(it - m1)
    fp = torch.exp(ft + m0 - m1)
    c1 = fp * c0 + ip * z.float()
    n1 = fp * n0 + ip
    h1 = (o.float() * (c1 / torch.clamp(n1, min=1e-6))).to(h0.dtype)
    return (c1, n1, h1, m1), h1


def slstm_forward(x, p, cfg, state=None):
    """Sequential sLSTM over (B, S, d).  Returns (y, new_state)."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    proj = lambda w: torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))
    xz, xi, xf, xo = proj(p["wz"]), proj(p["wi"]), proj(p["wf"]), proj(p["wo"])
    if state is None:
        state = init_slstm_state(b, cfg, device=x.device)
    carry = (state["c"], state["n"], state["h"], state["m"])
    hs = []
    for t in range(s):
        carry, h1 = _slstm_step(p, carry, (xz[:, t], xi[:, t], xf[:, t],
                                           xo[:, t]))
        hs.append(h1)
    hs = torch.stack(hs, dim=1).to(x.dtype)              # (B,S,H,hd)
    flat = apply_norm(hs.reshape(b, s, h * hd), p["norm"])
    y = torch.einsum("bshk,hkd->bsd", flat.reshape(b, s, h, hd),
                     p["w_out"].to(x.dtype))
    c1, n1, h1, m1 = carry
    return y, {"c": c1, "n": n1, "h": h1, "m": m1}


def slstm_decode(x, p, cfg, state):
    y, st = slstm_forward(x, p, cfg, state)
    return y, st


def init_slstm_state(batch, cfg, *, lead=(), device=None):
    h, hd = cfg.n_heads, cfg.head_dim
    lead, dev = tuple(lead), resolve_device(device)
    z = lambda: torch.zeros(lead + (batch, h, hd), dtype=torch.float32,
                            device=dev)
    return {"c": z(), "n": z(), "h": z(), "m": z()}
