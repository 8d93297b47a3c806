"""Shared model components: params-with-logical-axes, norms, RoPE, MLPs.

Every parameter is created together with a *logical axes* tuple (one entry
per tensor dim, e.g. ``("embed", "ffn")``), the JAX package's vocabulary,
so a tree of either package names the same dims.  On one device the axes
are carried and not read; on a device mesh ``parallel/sharding.py`` maps
them to placements (TP over 'model', FSDP over the data axes).

Initializers take an explicit ``torch.Generator`` as ``key`` (the JAX
package's PRNG key) and draw on the generator's device.  ``lead`` prefixes
a shape with stacked layer dims: a stacked parameter is allocated once at
its full ``lead + shape`` and filled in place, with the per-layer fan-in,
instead of stacking per-layer tensors (at 12 B parameters a stack of
copies doubles the peak).  The arithmetic copies the JAX package's casts
one for one: norms compute in float32 and cast back, RoPE's cos/sin are
cast to ``x.dtype``, and RoPE turns interleaved pairs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.device import resolve_device
from repro_torch.parallel import act

__all__ = ["ParamsWithAxes", "dense_init", "zeros_init", "ones_init",
           "split_tree", "tree_map", "tree_leaves", "tree_leaves_with_path",
           "rmsnorm", "layernorm", "norm_init", "apply_norm", "rope_angles",
           "apply_rope", "mlp_init", "mlp_apply", "embed_init",
           "embed_lookup", "logits_from_embedding", "cross_entropy",
           "cross_entropy_streamed"]

# Logical axis vocabulary (the JAX package's):
#   vocab   - vocabulary dim               -> TP
#   embed   - d_model dim of weights       -> FSDP
#   ffn     - MLP hidden dim               -> TP
#   heads   - query heads                  -> TP
#   kv      - kv heads                     -> TP (if divisible)
#   layers  - stacked layer dim            -> replicated


@dataclasses.dataclass
class ParamsWithAxes:
    params: Any
    axes: Any


def tree_map(fn, *trees, is_leaf=None):
    """``fn`` over the leaves of nested dicts (the port's ``jax.tree.map``):
    ``None`` stays ``None``; ``is_leaf`` stops the walk at a dict."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict) and not (is_leaf and is_leaf(first)):
        return {k: tree_map(fn, *(t[k] for t in trees), is_leaf=is_leaf)
                for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in insertion order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_leaves_with_path(tree, path=()) -> list:
    """``(path, leaf)`` pairs in the JAX package's leaf order
    (``jax.tree_util.tree_flatten_with_path``): dict keys sorted, list and
    tuple entries by index, ``None`` an empty subtree.  What the optimizer
    sums in and the checkpoint names files by."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def _lead_axes(lead, axes):
    return ("layers",) * len(lead) + tuple(axes)


def dense_init(key, shape, axes, in_axis=0, dtype=torch.float32, scale=1.0,
               *, lead=(), device=None):
    """He/LeCun-style init; returns (tensor, axes).  ``in_axis`` indexes
    ``shape`` (the per-layer shape).  The draw is on ``device``, by default
    ``key``'s (``meta`` takes any generator and allocates nothing)."""
    fan_in = int(np.prod([shape[i] for i in np.atleast_1d(in_axis)]))
    std = scale / np.sqrt(max(fan_in, 1))
    x = torch.randn(tuple(lead) + tuple(shape), generator=key, dtype=dtype,
                    device=key.device if device is None else device)
    return x.mul_(float(std)), _lead_axes(lead, axes)


def zeros_init(shape, axes, dtype=torch.float32, *, lead=(), device=None):
    return (torch.zeros(tuple(lead) + tuple(shape), dtype=dtype,
                        device=resolve_device(device)), _lead_axes(lead, axes))


def ones_init(shape, axes, dtype=torch.float32, *, lead=(), device=None):
    return (torch.ones(tuple(lead) + tuple(shape), dtype=dtype,
                       device=resolve_device(device)), _lead_axes(lead, axes))


def split_tree(pairs: dict) -> ParamsWithAxes:
    """{'name': (param, axes) | nested dict} -> ParamsWithAxes."""
    params, axes = {}, {}
    for k, v in pairs.items():
        if isinstance(v, dict):
            sub = split_tree(v)
            params[k], axes[k] = sub.params, sub.axes
        elif isinstance(v, ParamsWithAxes):
            params[k], axes[k] = v.params, v.axes
        else:
            params[k], axes[k] = v
    return ParamsWithAxes(params, axes)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps=1e-6, plus_one=False):
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = (1.0 + w) if plus_one else w
    return (x * scale).to(dt)


def layernorm(x, w, b, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps) * w + b
    return y.to(dt)


def norm_init(d, kind="rmsnorm", *, lead=(), device=None):
    if kind == "rmsnorm":
        return {"w": ones_init((d,), (None,), lead=lead, device=device)}
    return {"w": ones_init((d,), (None,), lead=lead, device=device),
            "b": zeros_init((d,), (None,), lead=lead, device=device)}


def apply_norm(x, p, kind="rmsnorm", plus_one=False):
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"], plus_one=plus_one)
    return layernorm(x, p["w"], p["b"])


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def _rope_freqs(dim: int, theta: float, device: torch.device):
    """The float32 inverse frequencies, computed on the host as the JAX
    package computes them and placed once per device: an upload per call
    would synchronise the stream in every layer of a decode step."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope_angles(positions, dim, theta=10_000.0):
    """positions (...,) -> (..., dim/2) angles."""
    return positions[..., None].float() * _rope_freqs(dim, float(theta),
                                                      positions.device)


def apply_rope(x, positions, theta=10_000.0, fraction=1.0):
    """x: (B, S, H, hd); positions: (B, S).  Rotates the first
    ``fraction * hd`` dims (partial rotary, stablelm-style), in
    interleaved pairs ``x[..., ::2]`` / ``x[..., 1::2]``."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    ang = rope_angles(positions, rot, theta)           # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp], dim=-1) if rot < hd else yr


# ---------------------------------------------------------------------------
# MLPs (gated silu/gelu and plain)
# ---------------------------------------------------------------------------
def mlp_init(key, d_model, d_ff, act="silu", dtype=torch.float32, *,
             lead=(), device=None):
    gated = act in ("silu", "geglu")
    kw = dict(lead=lead, device=device)
    p = {
        "w_up": dense_init(key, (d_model, d_ff), ("embed", "ffn"), 0, dtype,
                           **kw),
        "w_down": dense_init(key, (d_ff, d_model), ("ffn", "embed"), 0,
                             dtype, **kw),
    }
    if gated:
        p["w_gate"] = dense_init(key, (d_model, d_ff), ("embed", "ffn"), 0,
                                 dtype, **kw)
    return p


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def mlp_apply(x, p, act="silu"):
    up = x @ p["w_up"]
    if act == "silu":
        h = F.silu(x @ p["w_gate"]) * up
    elif act == "geglu":
        h = _gelu(x @ p["w_gate"]) * up
    else:  # plain gelu MLP (whisper)
        h = _gelu(up)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Token embedding / logits
# ---------------------------------------------------------------------------
def embed_init(key, vocab, d_model, dtype=torch.float32, *, device=None):
    return dense_init(key, (vocab, d_model), ("vocab", "embed"), 1, dtype,
                      device=device)


def embed_lookup(tokens, table, scale_by_sqrt_dim=False):
    x = (_lookup_on_mesh(tokens, table)
         if act.is_dtensor(table) and act.current() is not None
         else table[tokens])
    if scale_by_sqrt_dim:
        # sqrt(d) rounded to x's dtype first, as the JAX package casts it
        s = torch.tensor(np.sqrt(table.shape[-1]), dtype=x.dtype)
        x = x * s.item()
    return x


def _lookup_on_mesh(tokens, table):
    """``table[tokens]`` of a DTensor table (V, d), a local region: each
    rank gathers the rows of its slice of the vocab (the table's d_model
    dim gathered whole) for its batch shard of the tokens, 0 for a token
    outside the slice, and the rows are summed over 'model'.  The table's
    gradient leaves the region summed over the data axes the tokens are
    split on (each shard's tokens add their own rows).  DTensor's own
    indexing puts an ``index_put`` of a ``Partial`` table gradient in the
    backward, whose sharding some torch versions cannot propagate."""
    ctx = act.current()
    mesh = ctx["mesh"]
    dp = act.data_entry(ctx, tokens.shape[0])
    vocab = act.model_entry(ctx, table.shape[0])
    rows = act.region(ctx, 1, d0=dp)      # the tokens' and the rows'
    pl = act.region(ctx, 2, d0=vocab)
    local = act.to_local(table, mesh, pl, act.summed_over(mesh, pl, dp))
    tok = act.to_local(tokens, mesh, rows).long()
    if vocab is None or mesh.shape[vocab] == 1:
        return act.from_local(local[tok], mesh, rows)
    width = local.shape[0]
    rel = tok - mesh.coordinate()[vocab] * width
    mine = (rel >= 0) & (rel < width)
    x = local[torch.clamp(rel, 0, width - 1)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype))
    x = act.from_local(x, mesh, act.summed_over(mesh, rows, vocab))
    return x.redistribute(mesh.device_mesh, rows)


def logits_from_embedding(x, table, softcap=None):
    out = x @ table.T
    if softcap is not None:
        out = torch.tanh(out / softcap) * softcap
    return out


def _nll(logits, labels):
    """(logsumexp, the label's logit) of float32 logits over the vocab."""
    if act.is_dtensor(logits):
        return _nll_on_mesh(logits, labels)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse, ll


def _nll_on_mesh(logits, labels):
    """``_nll`` of DTensor logits (B, S, V), a local region over the batch
    shards.  A vocab split over ``model`` (the logits anchor's placement)
    takes the logsumexp as ``torch.logsumexp`` computes it -- the max,
    then the log of the summed exponentials -- with the max and the sum
    reduced across ``model``, and the label's logit from the rank whose
    slice of the vocab holds it (the others add 0): DTensor's sharded
    ``gather`` leaves a masked partial that it cannot reduce.  A whole
    vocab runs the plain ``_nll`` on each shard."""
    from torch.distributed.tensor import Shard

    ctx = act.current()
    mesh = ctx["mesh"]
    dp = act.data_entry(ctx, logits.shape[0])
    vocab = act.model_entry(ctx, logits.shape[2])
    pl = act.region(ctx, 3, d0=dp, d2=vocab)
    rows = act.region(ctx, 2, d0=dp)
    if not any(isinstance(p, Shard) and p.dim == 2 for p in pl):
        lse, ll = _nll(act.to_local(logits, mesh, pl),
                       act.to_local(labels, mesh, rows))
        return act.from_local(lse, mesh, rows), act.from_local(ll, mesh,
                                                               rows)
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    local = act.to_local(logits, mesh, pl)
    lab = act.to_local(labels, mesh, rows).long()
    width = local.shape[-1]
    lo = mesh.coordinate()[vocab] * width
    rel = lab - lo
    mine = (rel >= 0) & (rel < width)
    ll = torch.gather(local, -1, torch.clamp(rel, 0, width - 1)[..., None])
    ll = torch.where(mine, ll[..., 0], torch.zeros((), dtype=ll.dtype))
    ll = act.from_local(ll, mesh, act.summed_over(mesh, rows, vocab))
    return lse, ll.redistribute(mesh.device_mesh, rows)


def cross_entropy(logits, labels, mask=None, z_loss=0.0):
    """Token-mean cross entropy in f32, optional z-loss regularizer."""
    logits = logits.float()
    lse, ll = _nll(logits, labels)
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    if mask is None:
        return loss.mean()
    mask = mask.float()
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def cross_entropy_streamed(x, table, labels, mask=None, softcap=None,
                           chunk: int = 512):
    """CE against a tied embedding without materializing (B, S, V) logits.

    Walks the sequence in chunks of ``chunk`` (then the remainder); each
    chunk's logits are reduced to (B, chunk) statistics before the next
    chunk's are made, and each full chunk's loss runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so its
    float32 logits are recomputed in the backward pass and only one
    chunk's are ever live.  On a mesh each chunk's logits are anchored as
    the reference anchors them (batch over the data axes, vocab over
    'model'), pinned (``act.pin``: the sequence whole, the gradient placed
    the same).
    """
    b, s, d = x.shape
    chunk = min(chunk, s)
    n = s // chunk
    rem = s - n * chunk

    def chunk_loss(xs, ls, ms):
        logits = xs @ table.T.to(xs.dtype)
        if softcap is not None:
            logits = torch.tanh(logits / softcap) * softcap
        logits = act.pin(logits, d0="data", d2="model")
        lse, ll = _nll(logits.float(), ls)
        loss = (lse - ll) * ms
        return loss.sum(), ms.sum()

    def ones(width):
        return torch.ones((b, width), dtype=torch.float32, device=x.device)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        ms = mask[:, sl].float() if mask is not None else ones(chunk)
        dl, dc = torch_checkpoint.checkpoint(
            act.keep_context(chunk_loss), x[:, sl], labels[:, sl], ms,
            use_reentrant=False)
        tot, cnt = tot + dl, cnt + dc
    if rem:
        ms = mask[:, n * chunk:].float() if mask is not None else ones(rem)
        dl, dc = chunk_loss(x[:, n * chunk:], labels[:, n * chunk:], ms)
        tot, cnt = tot + dl, cnt + dc
    return tot / torch.clamp(cnt, min=1.0)
