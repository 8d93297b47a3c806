"""Attention: GQA/MQA with chunked online-softmax, local windows, KV caches.

Long sequences never materialize the full (Sq, Skv) score matrix: the
chunked path walks KV blocks with running (max, sum, acc) statistics —
flash-attention dataflow written as plain PyTorch products, the JAX
package's arithmetic (scores and the running statistics in float32,
masked scores ``-1e30``), not a fused attention library.

Decode uses a position-tagged cache: a ``pos`` tensor rides along with k/v
so global caches and ring-buffer (sliding-window) caches share one masking
rule: ``valid = (pos <= current) & (pos > current - window)``.  Caches are
preallocated and written in place (the JAX package's donated
``dynamic_update_slice``); a decode position may be a 0-dim device tensor,
so a decode step never waits on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["NEG_INF", "attention", "init_cache", "cache_prefill",
           "cache_append", "decode_attention"]

NEG_INF = -1e30


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (ragged seqs, e.g. vlm
    patch prefixes, still chunk evenly)."""
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return n


def _mask(pos_q, pos_k, causal: bool, window: Optional[int]):
    """(q, k) boolean validity mask from absolute positions."""
    m = torch.ones((pos_q.shape[-1], pos_k.shape[-1]), dtype=torch.bool,
                   device=pos_q.device)
    if causal:
        m &= pos_q[:, None] >= pos_k[None, :]
    if window is not None:
        m &= pos_q[:, None] - pos_k[None, :] < window
    return m


def _scores(q, k, softcap):
    # q: (B, qc, Hkv, G, hd); k: (B, kc, Hkv, hd) -> (B, Hkv, G, qc, kc)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    return s


def _scaled(q, hd):
    # the JAX package multiplies q by a NumPy float64 scalar, which JAX
    # holds as a strongly typed float32: the product is float32 whatever
    # q's dtype
    return q.float() * float(np.float32(1.0 / np.sqrt(hd)))


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    softcap: Optional[float] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    dense_threshold: int = 2048,
) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd); Hq % Hkv == 0.
    ``q_offset``: absolute position of q[0] relative to k[0] (prefill
    continuation); scores are scaled by 1/sqrt(hd).  Up to
    ``dense_threshold`` keys one dense pass (probabilities cast to v's
    dtype before P·V); above it the chunked online softmax (P·V in
    float32, the output cast to q's dtype).
    """
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    vd = v.shape[-1]                    # MLA: v_dim may differ from q/k dim
    g = hq // hkv
    qg = _scaled(q, hd).reshape(b, sq, hkv, g, hd)
    dev = q.device

    if skv <= dense_threshold:
        s = _scores(qg, k, softcap)
        pos_q = q_offset + torch.arange(sq, device=dev)
        pos_k = torch.arange(skv, device=dev)
        s = torch.where(_mask(pos_q, pos_k, causal, window), s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
        return o.reshape(b, sq, hq, vd)

    # --- chunked online-softmax path -------------------------------------
    q_chunk = _pick_chunk(sq, q_chunk)
    kv_chunk = _pick_chunk(skv, kv_chunk)
    nq, nk = sq // q_chunk, skv // kv_chunk
    vf = v.float()
    outs = []
    for qi in range(nq):
        q_blk = qg[:, qi * q_chunk:(qi + 1) * q_chunk]
        pos_q = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, hkv, g, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, q_chunk), device=dev)
        acc = torch.zeros((b, hkv, g, q_chunk, vd), device=dev)
        for ki in range(nk):
            k_blk = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            v_blk = vf[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            s = _scores(q_blk, k_blk, softcap)  # (B,Hkv,G,qc,kc)
            pos_k = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.where(_mask(pos_q, pos_k, causal, window), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk)
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]    # (B,Hkv,G,qc,vd)
        outs.append(o.permute(0, 3, 1, 2, 4))             # (B,qc,Hkv,G,vd)
    o = torch.cat(outs, dim=1).reshape(b, sq, hq, vd)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# KV caches (position-tagged; supports global and ring/sliding layouts)
# ---------------------------------------------------------------------------
def init_cache(batch, length, n_kv, head_dim, dtype=torch.bfloat16, *,
               lead=(), device=None):
    """Zeroed k/v and ``pos`` tags of -1; ``lead`` prefixes stacked layer
    dims (one allocation for every layer of a group stack)."""
    dev = resolve_device(device)
    lead = tuple(lead)
    return {
        "k": torch.zeros(lead + (batch, length, n_kv, head_dim), dtype=dtype,
                         device=dev),
        "v": torch.zeros(lead + (batch, length, n_kv, head_dim), dtype=dtype,
                         device=dev),
        "pos": torch.full(lead + (batch, length), -1, dtype=torch.int32,
                          device=dev),
    }


def cache_prefill(cache, k, v, start: int = 0):
    """Write k/v (B, S, Hkv, hd) at positions [start, start + S), in place."""
    s = k.shape[1]
    cache["k"][:, start:start + s] = k
    cache["v"][:, start:start + s] = v
    cache["pos"][:, start:start + s] = torch.arange(
        start, start + s, dtype=torch.int32, device=k.device)
    return cache


def cache_append(cache, k_new, v_new, index):
    """Insert one token at absolute position ``index`` (an int or a 0-dim
    tensor) into slot ``index % length``, in place (ring if the cache is
    shorter than the stream)."""
    length = cache["k"].shape[1]
    index = torch.as_tensor(index, dtype=torch.int32,
                            device=cache["pos"].device)
    slot = (index % length).long().view(1)
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    b = cache["pos"].shape[0]
    cache["pos"].index_copy_(1, slot, index.view(1, 1).expand(b, 1))
    return cache


def decode_attention(q, cache, index, *, window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a position-tagged cache.

    q: (B, 1, Hq, hd); returns (B, 1, Hq, hd).
    """
    b, _, hq, hd = q.shape
    hkv = cache["k"].shape[2]
    g = hq // hkv
    qg = _scaled(q, hd).reshape(b, 1, hkv, g, hd)
    s = _scores(qg, cache["k"], softcap)[:, :, :, 0, :]  # (B,Hkv,G,S)
    pos = cache["pos"]                                    # (B,S)
    valid = (pos >= 0) & (pos <= index)
    if window is not None:
        valid &= pos > index - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(cache["v"].dtype), cache["v"])
    return o.reshape(b, 1, hq, hd).to(q.dtype)
