"""Multi-head Latent Attention (DeepSeek-V2) with absorbed decode.

Training/prefill computes standard multi-head attention over decompressed
keys/values; the cache stores only the latent ``c_kv`` (kv_lora dims) plus
the shared rotary key — the MLA memory win (512+64 vs 2*128*128 per token).

Decode uses the *absorption* identities: W_uk folds into the query
(q' = q @ W_uk^T) and W_uv folds into the output projection, so per-step
attention runs directly against the latent cache with no decompression.

The reference's casts are kept: the absorbed scores are float32 products
of model-dtype operands (``preferred_element_type=float32``), the
probabilities are cast back to the model dtype before the latent P·V.  The
latent cache is preallocated and written in place at ``index % length``,
with the index a 0-dim device tensor, as the GQA caches are.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (apply_norm, apply_rope, dense_init,
                                       norm_init)
from repro_torch.parallel import act

__all__ = ["init_mla", "init_cache", "mla_forward", "mla_decode"]


def init_mla(key, cfg, dtype=torch.float32, *, lead=(), device=None):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_dim = m.nope_dim + m.rope_dim
    kw = dict(lead=lead, device=device)
    dev = key.device if device is None else device
    return {
        "w_dq": dense_init(key, (d, m.q_lora), ("embed", "qlora"), 0, dtype,
                           **kw),
        "q_norm": norm_init(m.q_lora, lead=lead, device=dev),
        "w_uq": dense_init(key, (m.q_lora, h, qk_dim),
                           ("qlora", "heads", None), 0, dtype, **kw),
        "w_dkv": dense_init(key, (d, m.kv_lora + m.rope_dim),
                            ("embed", "kvlora"), 0, dtype, **kw),
        "kv_norm": norm_init(m.kv_lora, lead=lead, device=dev),
        "w_uk": dense_init(key, (m.kv_lora, h, m.nope_dim),
                           ("kvlora", "heads", None), 0, dtype, **kw),
        "w_uv": dense_init(key, (m.kv_lora, h, m.v_dim),
                           ("kvlora", "heads", None), 0, dtype, **kw),
        "wo": dense_init(key, (h, m.v_dim, d), ("heads", None, "embed"),
                         (0, 1), dtype, **kw),
    }


def init_cache(batch, length, cfg, dtype=torch.bfloat16, *, lead=(),
               device=None):
    """The zeroed latent cache ``{c_kv, k_rope, pos}`` (``pos`` tags -1);
    ``lead`` prefixes stacked layer dims (the reference's
    ``_init_cache_for`` for ``mla``)."""
    m = cfg.mla
    dev = resolve_device(device)
    lead = tuple(lead)
    return {
        "c_kv": torch.zeros(lead + (batch, length, m.kv_lora), dtype=dtype,
                            device=dev),
        "k_rope": torch.zeros(lead + (batch, length, m.rope_dim),
                              dtype=dtype, device=dev),
        "pos": torch.full(lead + (batch, length), -1, dtype=torch.int32,
                          device=dev),
    }


def _latents(x, p, cfg, positions):
    """Shared path: query heads + latent kv + rotary shared key."""
    m = cfg.mla
    cq = apply_norm(x @ p["w_dq"].to(x.dtype), p["q_norm"])
    q = torch.einsum("bsl,lhk->bshk", cq, p["w_uq"].to(x.dtype))
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = x @ p["w_dkv"].to(x.dtype)
    c_kv = apply_norm(dkv[..., :m.kv_lora], p["kv_norm"])
    k_rope = dkv[..., m.kv_lora:][:, :, None, :]          # (B,S,1,rope)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(x, p, cfg, *, q_offset: int = 0, make_cache=False,
                cache_len=None, cache=None):
    """Train/prefill MLA. Returns (out, cache|None).  ``cache`` (port
    only) is a preallocated latent cache to fill in place, e.g. one
    layer's view of a stacked cache."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    positions = q_offset + torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _latents(x, p, cfg, positions)

    k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uk"].to(x.dtype))
    v = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uv"].to(x.dtype))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.rope_dim)], dim=-1)
    o = attn_lib.attention(q, k, v, causal=True, q_offset=q_offset)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))

    if not make_cache:
        return out, None
    if cache is None:
        cache = init_cache(b, cache_len or s, cfg, x.dtype, device=x.device)
    if act.is_dtensor(cache["c_kv"]):    # a mesh: each rank its part
        attn_lib.write_rows(cache["c_kv"], c_kv, 0)
        attn_lib.write_rows(cache["k_rope"], k_rope[:, :, 0, :], 0)
        attn_lib.write_rows(cache["pos"], torch.arange(
            s, dtype=torch.int32, device=x.device)[None].expand(b, s), 0)
        return out, cache
    cache["c_kv"][:, :s] = c_kv
    cache["k_rope"][:, :s] = k_rope[:, :, 0, :]
    cache["pos"][:, :s] = torch.arange(s, dtype=torch.int32, device=x.device)
    return out, cache


def mla_decode(x, p, cfg, cache, index):
    """Absorbed one-token decode against the latent cache, written in
    place.  index: absolute position (an int or a 0-dim tensor on x's
    device)."""
    m = cfg.mla
    b = x.shape[0]
    index = torch.as_tensor(index, dtype=torch.int32, device=x.device)
    positions = index.view(1, 1).expand(b, 1)
    q_nope, q_rope, c_kv_new, k_rope_new = _latents(x, p, cfg, positions)

    scale = float(np.float32(1.0 / np.sqrt(m.nope_dim + m.rope_dim)))
    if act.is_dtensor(cache["c_kv"]):
        return _mla_decode_on_mesh(x, p, cfg, cache, index, q_nope, q_rope,
                                   c_kv_new, k_rope_new, scale), cache

    # append to the latent cache
    slot = (index % cache["c_kv"].shape[1]).long().view(1)
    cache["c_kv"].index_copy_(1, slot, c_kv_new.to(cache["c_kv"].dtype))
    cache["k_rope"].index_copy_(
        1, slot, k_rope_new[:, :, 0, :].to(cache["k_rope"].dtype))
    cache["pos"].index_copy_(1, slot, index.view(1, 1).expand(b, 1))

    # absorb W_uk into q: score_nope = (q_nope @ W_uk^T) . c_kv
    # (float32 products of model-dtype operands, as the reference asks)
    q_lat = torch.einsum("bshk,lhk->bshl", q_nope.float(),
                         p["w_uk"].to(x.dtype).float())
    s_nope = torch.einsum("bshl,btl->bhst", q_lat, cache["c_kv"].float())
    s_rope = torch.einsum("bshk,btk->bhst", q_rope.float(),
                          cache["k_rope"].float())
    s = (s_nope + s_rope) * scale
    pos = cache["pos"]
    valid = (pos >= 0) & (pos <= index)
    s = torch.where(valid[:, None, None, :], s, attn_lib.NEG_INF)
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    # attend in latent space, then absorb W_uv into the output projection
    o_lat = torch.einsum("bhst,btl->bshl", pr, cache["c_kv"])
    o = torch.einsum("bshl,lhk->bshk", o_lat, p["w_uv"].to(x.dtype))
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, cache


def _mla_decode_on_mesh(x, p, cfg, cache, index, q_nope, q_rope, c_kv_new,
                        k_rope_new, scale):
    """``mla_decode`` on a mesh: the latent cache written by each rank in
    its part (batch over the data axes, the sequence over 'model' when it
    divides); the scores and the latent-space P·V over each rank's keys,
    the softmax and the sum reduced across the sequence's mesh dim."""
    b = x.shape[0]
    length = cache["c_kv"].shape[1]
    dev = cache["pos"].to_local().device
    index = torch.as_tensor(index, dtype=torch.int32, device=dev)
    attn_lib.write_slot(cache["c_kv"], c_kv_new, index, length)
    attn_lib.write_slot(cache["k_rope"], k_rope_new[:, :, 0, :], index,
                        length)
    attn_lib.write_slot(cache["pos"], index.view(1, 1).expand(b, 1), index,
                        length)
    q_lat = torch.einsum("bshk,lhk->bshl", q_nope.float(),
                         p["w_uk"].to(x.dtype).float())
    leaf = cache["c_kv"]
    ql = attn_lib.local_source(q_lat, leaf)
    qr = attn_lib.local_source(q_rope.float(), leaf)
    ckv, kr = leaf.to_local(), cache["k_rope"].to_local()
    pos = attn_lib.local_positions(leaf, cache["pos"])
    s = (torch.einsum("bshl,btl->bhst", ql, ckv.float())
         + torch.einsum("bshk,btk->bhst", qr, kr.float())) * scale
    valid = (pos >= 0) & (pos <= index)
    s = torch.where(valid[:, None, None, :], s, attn_lib.NEG_INF)
    split = attn_lib._seq_split(leaf) is not None
    pr = (attn_lib.seq_softmax(s, leaf) if split
          else torch.softmax(s, dim=-1)).to(x.dtype)
    if split:
        o_lat = attn_lib.seq_sum(torch.einsum(
            "bhst,btl->bshl", pr.float(), ckv.float()), leaf).to(x.dtype)
    else:
        o_lat = torch.einsum("bhst,btl->bshl", pr, ckv)
    o_lat = act.from_local(o_lat, leaf.device_mesh,
                           attn_lib.whole_sequence(leaf))
    o = torch.einsum("bshl,lhk->bshk", o_lat, p["w_uv"].to(x.dtype))
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
