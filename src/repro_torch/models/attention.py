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

On a device mesh (an activation context with DTensor inputs) attention
and the cache reads and writes run as local regions: each rank takes its
batch shard (the reference's ``shard_batch`` anchors) and its heads (when
every head count divides over ``model``); a cache whose kv heads do not
divide holds its sequence dim over ``model`` instead, and decode reduces
the softmax over that dim with explicit collectives (max, sum and P·V
over the ``model`` group).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.parallel import act

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


def _kv_slice(hq: int, hkv: int, n: int, rank: int):
    """The kv heads the query heads ``[rank * hq / n, (rank + 1) * hq / n)``
    attend to, as a slice, when those query heads cover whole groups or
    lie inside one; else ``None``."""
    g, hl = hq // hkv, hq // n
    if hl % g == 0:
        return slice(rank * hl // g, (rank + 1) * hl // g)
    if g % hl == 0:
        lo = rank * hl // g
        return slice(lo, lo + 1)
    return None


def _attention_on_mesh(ctx, q, k, v, kw):
    """``attention`` as a local region: the batch over the data axes (the
    reference's ``shard_batch`` anchors), the heads over 'model' where
    they divide.  Query heads that divide while the kv heads do not keep
    k and v replicated over 'model' (as the projections leave them) and
    each rank takes the kv heads its query heads attend to; their
    gradient leaves the region summed over 'model'."""
    from torch.distributed.tensor import Partial

    q, k, v = act.shard_batch(q), act.shard_batch(k), act.shard_batch(v)
    mesh = ctx["mesh"]
    dp = act.data_entry(ctx, q.shape[0])
    both = act.model_entry(ctx, q.shape[2], k.shape[2])
    pl = act.region(ctx, 4, d0=dp, d2=both)
    heads = act.model_entry(ctx, q.shape[2]) if both is None else None
    kv = (None if heads is None else _kv_slice(
        q.shape[2], k.shape[2], mesh.shape[heads],
        mesh.coordinate()[heads]))
    if kv is None:
        o = attention(*(act.to_local(t, mesh, pl) for t in (q, k, v)), **kw)
        return act.from_local(o, mesh, pl)
    q_pl = act.region(ctx, 4, d0=dp, d2=heads)
    summed = tuple(Partial() if n == heads else p
                   for n, p in zip(mesh.axis_names, pl))
    kl, vl = (act.to_local(t, mesh, pl, summed)[:, :, kv] for t in (k, v))
    o = attention(act.to_local(q, mesh, q_pl), kl, vl, **kw)
    return act.from_local(o, mesh, q_pl)


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
    ctx = act.current()
    if ctx is not None and act.is_dtensor(q):
        return _attention_on_mesh(ctx, q, k, v, dict(
            causal=causal, window=window, q_offset=q_offset, softcap=softcap,
            q_chunk=q_chunk, kv_chunk=kv_chunk,
            dense_threshold=dense_threshold))
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


def _seq_split(cache_leaf):
    """(mesh dim, this rank's index along it) when the cache leaf holds
    its sequence dim (1) over a mesh dim, else ``None``."""
    from torch.distributed.tensor import Shard

    for i, p in enumerate(cache_leaf.placements):
        if isinstance(p, Shard) and p.dim == 1:
            return i, cache_leaf.device_mesh.get_local_rank(i)
    return None


def whole_sequence(leaf) -> tuple:
    """The cache leaf's placements with a split sequence dim replicated:
    how a source of a write into it, or a query against it, is placed."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in leaf.placements)


def local_source(t, like):
    """``t`` (a DTensor or a plain tensor, the same on every rank) as the
    local source of a write into the cache leaf ``like``, each rank then
    writing its part of a split sequence."""
    return act.to_local(t, like.device_mesh, whole_sequence(like))


def write_rows(leaf, src, start: int) -> None:
    """Rows [start, start + S) of the DTensor cache leaf (dim 1) from
    ``src``, each rank writing the rows inside its part of a split
    sequence."""
    dst, src = leaf.to_local(), local_source(src, leaf)
    s, length, lo = src.shape[1], dst.shape[1], 0
    split = _seq_split(leaf)
    if split is not None:
        lo = split[1] * length
    a, b = max(start, lo), min(start + s, lo + length)
    if a < b:
        dst[:, a - lo:b - lo] = src[:, a - start:b - start].to(dst.dtype)


def write_slot(leaf, src, index, length: int) -> None:
    """Slot ``index % length`` (a 0-dim tensor: no host sync) of the
    DTensor cache leaf (dim 1) from ``src`` (one row); with a split
    sequence only the rank whose part holds the slot writes it (a masked
    write)."""
    dst, src = leaf.to_local(), local_source(src, leaf).to(leaf.dtype)
    slot = (index % length).long().view(1)
    split = _seq_split(leaf)
    if split is None:
        dst.index_copy_(1, slot, src)
        return
    part = dst.shape[1]
    loc = slot - split[1] * part
    mine = (loc >= 0) & (loc < part)
    loc = torch.clamp(loc, 0, part - 1)
    dst.index_copy_(1, loc, torch.where(mine, src, dst.index_select(1, loc)))


def seq_softmax(s, leaf):
    """Softmax over the last dim of local scores ``s`` whose keys are this
    rank's part of the cache leaf's split sequence: the max, then the sum
    of the exponentials, all-reduced over that mesh dim's group."""
    import torch.distributed as dist

    group = leaf.device_mesh.get_group(_seq_split(leaf)[0])
    m = s.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(s - m)
    total = e.sum(dim=-1, keepdim=True)
    dist.all_reduce(total, group=group)
    return e / total


def seq_sum(t, leaf):
    """``t`` summed over the mesh dim that splits the cache leaf's
    sequence (a P·V over each rank's part of the keys)."""
    import torch.distributed as dist

    dist.all_reduce(t, group=leaf.device_mesh.get_group(
        _seq_split(leaf)[0]))
    return t


def local_positions(leaf, pos):
    """This rank's slice of the (batch-only placed) position tags for the
    part of the sequence it holds of ``leaf``."""
    pos = pos.to_local()
    split = _seq_split(leaf)
    if split is None:
        return pos
    part = leaf.to_local().shape[1]
    return pos[:, split[1] * part:(split[1] + 1) * part]


def _cache_prefill_local(cache, k, v, start: int):
    """The mesh write: each rank fills its shard of k, v and the tags."""
    write_rows(cache["k"], k, start)
    write_rows(cache["v"], v, start)
    write_rows(cache["pos"], torch.arange(
        start, start + k.shape[1], dtype=torch.int32,
        device=cache["pos"].to_local().device)[None].expand(
            cache["pos"].shape[0], -1), start)
    return cache


def cache_prefill(cache, k, v, start: int = 0):
    """Write k/v (B, S, Hkv, hd) at positions [start, start + S), in place."""
    if act.is_dtensor(cache["k"]):
        return _cache_prefill_local(cache, k, v, start)
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
    if act.is_dtensor(cache["k"]):
        return _cache_append_local(cache, k_new, v_new, index, length)
    index = torch.as_tensor(index, dtype=torch.int32,
                            device=cache["pos"].device)
    slot = (index % length).long().view(1)
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    b = cache["pos"].shape[0]
    cache["pos"].index_copy_(1, slot, index.view(1, 1).expand(b, 1))
    return cache


def _cache_append_local(cache, k_new, v_new, index, length: int):
    """The mesh append (see ``write_slot``)."""
    index = torch.as_tensor(index, dtype=torch.int32,
                            device=cache["pos"].to_local().device)
    write_slot(cache["k"], k_new, index, length)
    write_slot(cache["v"], v_new, index, length)
    b = cache["pos"].shape[0]
    write_slot(cache["pos"], index.view(1, 1).expand(b, 1), index, length)
    return cache


def _decode_attention_local(q, cache, index, window, softcap):
    """Decode on a mesh: batch and kv heads local; a sequence split over a
    mesh dim is reduced across it (``seq_softmax``, ``seq_sum``)."""
    kd = cache["k"]
    pl = whole_sequence(kd)
    ql = local_source(q, kd)
    kc, vc = kd.to_local(), cache["v"].to_local()
    pc = local_positions(kd, cache["pos"])
    if _seq_split(kd) is None:
        o = decode_attention(ql, {"k": kc, "v": vc, "pos": pc}, index,
                             window=window, softcap=softcap)
        return act.from_local(o, kd.device_mesh, pl)
    b, _, hq, hd = ql.shape
    hkv = kc.shape[2]
    qg = _scaled(ql, hd).reshape(b, 1, hkv, hq // hkv, hd)
    s = _scores(qg, kc, softcap)[:, :, :, 0, :]           # (B,Hkv,G,S/n)
    valid = (pc >= 0) & (pc <= index)
    if window is not None:
        valid &= pc > index - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = seq_softmax(s, kd).to(vc.dtype)
    o = seq_sum(torch.einsum("bhgk,bkhd->bhgd", p.float(), vc.float()), kd)
    o = o.to(vc.dtype).reshape(b, 1, hq, hd).to(ql.dtype)
    return act.from_local(o, kd.device_mesh, pl)


def decode_attention(q, cache, index, *, window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a position-tagged cache.

    q: (B, 1, Hq, hd); returns (B, 1, Hq, hd).
    """
    if act.is_dtensor(cache["k"]):
        return _decode_attention_local(q, cache, index, window, softcap)
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
