"""Mixture-of-Experts with capacity-based top-k routing.

Routing follows the standard capacity discipline (tokens beyond an expert's
capacity are dropped); dispatch is *sort-based* — assignments are sorted by
expert id, positions within an expert come from a searchsorted trick, and
activations are gathered only for assignments that landed, so no
(tokens x experts) one-hot tensor ever exists.  Every shape is static
(``n_gather = min(n_slots, T*k)``, dropped assignments parked on a sentinel
slot): a decode step never waits on the card for a data-dependent size.

The JAX package's arithmetic, with three PyTorch-specific choices:

- ``jax.lax.top_k`` takes the lower index on a tie and ``torch.topk``
  promises no order among ties, so the top k come from a stable
  descending sort;
- ``jnp.argsort`` is stable, so is the sort here; positions within an
  expert use ``searchsorted(side="left")`` as the reference does;
- the combine is the one departure in summation order: the reference
  scatter-adds each kept contribution into its token's row
  (``.at[tok].add``) in the sorted order, which on CUDA would be atomic
  adds whose order changes from run to run.  Here each contribution is
  written back to its own ``(token, k)`` position (a permutation: no two
  writes collide) and the ``k`` of a token are summed in rank order, so a
  step repeats bit for bit.

Distribution: on a mesh with more than one device on its data or model
axes the block runs as a local region per rank, the reference's
``shard_map``: tokens sharded over the data axes (replicated over
'model'), experts over 'model' (EP).  Each rank gathers its experts'
FSDP-sharded weights over the data axes, routes its own tokens, computes
its experts' partial output at the per-shard capacity, and the partial
outputs are summed over 'model'; the aux loss is averaged over the data
axes.  On a trivial mesh the ``mesh=None`` path runs on the local shards.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.parallel import act
from repro_torch.parallel.sharding import placements_by_axis

__all__ = ["init_moe", "moe_forward"]


def init_moe(key, cfg, dtype=torch.float32, *, lead=(), device=None):
    m = cfg.moe
    d = cfg.d_model
    kw = dict(lead=lead, device=device)
    p = {
        # the router stays float32 in every model dtype, as in the reference
        "router": dense_init(key, (d, m.n_experts), ("embed", "expert"), 0,
                             torch.float32, **kw),
        "w_gate": dense_init(key, (m.n_experts, d, m.d_expert),
                             ("expert", "embed", None), 1, dtype, **kw),
        "w_up": dense_init(key, (m.n_experts, d, m.d_expert),
                           ("expert", "embed", None), 1, dtype, **kw),
        "w_down": dense_init(key, (m.n_experts, m.d_expert, d),
                             ("expert", None, "embed"), 1, dtype, **kw),
    }
    if m.n_shared:
        dsh = m.d_expert * m.n_shared
        p["shared"] = {
            "w_gate": dense_init(key, (d, dsh), ("embed", "ffn"), 0, dtype,
                                 **kw),
            "w_up": dense_init(key, (d, dsh), ("embed", "ffn"), 0, dtype,
                               **kw),
            "w_down": dense_init(key, (dsh, d), ("ffn", "embed"), 0, dtype,
                                 **kw),
        }
    return p


def _route(x, router_w, m, aux: bool = True):
    """Top-k routing: returns (expert_idx, gate) each (T, k) + aux losses
    (``None`` when ``aux`` is false: the serving path drops them)."""
    logits = x.float() @ router_w.float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: descending, the lower index first on a tie
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :m.top_k], idx[:, :m.top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    if not aux:
        return idx, gate, None
    # load-balance aux (Switch-style) and router z-loss; the counts are
    # sums of ones, exact in any order
    me = probs.mean(0)                                      # (E,)
    ce = torch.zeros_like(me).index_add_(
        0, idx.reshape(-1), torch.ones_like(gate).reshape(-1)) / idx.numel()
    loss = m.n_experts * torch.sum(me * ce) * m.aux_loss
    z = torch.mean(torch.logsumexp(logits, -1) ** 2) * m.router_z_loss
    return idx, gate, loss + z


def _expert_ffn(buf, w_gate, w_up, w_down):
    """buf: (E_l, C, d) -> (E_l, C, d) through each expert's gated MLP."""
    g = torch.bmm(buf, w_gate.to(buf.dtype))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    h = F.silu(g) * u
    return torch.bmm(h, w_down.to(buf.dtype))


def _dispatch_compute(x, idx, gate, w_gate, w_up, w_down, e_lo, n_local,
                      capacity):
    """Sort-based dispatch for experts [e_lo, e_lo + n_local).

    x: (T, d); idx/gate: (T, k).  Returns (T, d) partial output containing
    only the local experts' contributions.
    """
    t, d = x.shape
    k = idx.shape[1]
    dev = x.device
    e_flat = idx.reshape(-1)
    g_flat = gate.reshape(-1)
    tok_flat = torch.arange(t * k, device=dev) // k       # jnp.repeat

    local = (e_flat >= e_lo) & (e_flat < e_lo + n_local)
    e_loc = torch.where(local, e_flat - e_lo, n_local)    # sentinel
    order = torch.argsort(e_loc, stable=True)             # by expert
    n_slots = n_local * capacity
    n_gather = min(n_slots, t * k)                         # static
    order = order[:n_gather]
    e_sorted = e_loc[order]
    pos = (torch.arange(n_gather, device=dev)
           - torch.searchsorted(e_sorted, e_sorted, side="left"))
    keep = (e_sorted < n_local) & (pos < capacity)
    slot = torch.where(keep, e_sorted * capacity + pos, n_slots)  # drops

    gathered = x[tok_flat[order]]                          # (n_gather, d)
    # kept slots are distinct; every drop lands on the discarded sentinel
    buf = torch.zeros((n_slots + 1, d), dtype=x.dtype, device=dev)
    buf.index_copy_(0, slot, gathered)
    buf = buf[:n_slots].reshape(n_local, capacity, d)

    out_buf = _expert_ffn(buf, w_gate, w_up, w_down)      # (E_l, C, d)
    out_flat = out_buf.reshape(n_slots, d)
    contrib = out_flat[torch.clamp(slot, max=n_slots - 1)]
    contrib = contrib * (keep * g_flat[order]).to(x.dtype)[:, None]
    # the combine: each contribution back to its own (token, k) position,
    # then a token's k summed in rank order (no atomics; see the module
    # docstring)
    per = torch.zeros((t * k, d), dtype=x.dtype, device=dev)
    per.index_copy_(0, order, contrib)
    return per.reshape(t, k, d).sum(1)


def moe_forward(x, p, cfg, mesh=None, data_axes=("data",), model_axis="model",
                fsdp_gather: bool = True, *, aux: bool = True):
    """x: (B, S, d) -> (y, aux_loss).

    When ``mesh`` spans real data/model axes the block runs as per-rank
    local regions (EP, ``_ep_forward``); otherwise it executes the same
    math locally (on a trivial mesh, on the local shards).  ``aux=False``
    (the serving path, which drops the loss) skips computing it and
    returns ``None`` in its place.
    """
    m = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    if mesh is not None and (
            int(np.prod([mesh.shape[a] for a in data_axes])) > 1
            or mesh.shape[model_axis] > 1):
        # the expert weights arrive as stored (FSDP-sharded on d_model
        # when ``fsdp_gather``); the region gathers whatever it needs
        y, loss = _ep_forward(xt, p, m, mesh, tuple(data_axes), model_axis,
                              aux)
    elif mesh is not None and act.is_dtensor(xt):
        y, loss = _trivial_mesh(xt, p, m, mesh, aux)
    else:
        y, loss = _local_forward(xt, p, m, aux)
    y = y.reshape(b, s, d)
    if m.n_shared:
        sh = p["shared"]
        g = F.silu(x @ sh["w_gate"].to(x.dtype))
        u = x @ sh["w_up"].to(x.dtype)
        y = y + (g * u) @ sh["w_down"].to(x.dtype)
    return y, loss


def _local_forward(xt, p, m, aux):
    """The ``mesh=None`` path on (T, d) tokens."""
    idx, gate, loss = _route(xt, p["router"], m, aux)
    cap = int(np.ceil(xt.shape[0] * m.top_k * m.capacity_factor
                      / m.n_experts))
    y = _dispatch_compute(xt, idx, gate, p["w_gate"], p["w_up"], p["w_down"],
                          0, m.n_experts, max(cap, 1))
    return y, loss


def _trivial_mesh(xt, p, m, mesh, aux):
    """A mesh of one device: the local path on the (whole) local shards."""
    from torch.distributed.tensor import Replicate

    rep = (Replicate(),) * mesh.device_mesh.ndim
    loc = lambda t: act.to_local(t, mesh, rep)
    w = {k: loc(p[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    y, loss = _local_forward(loc(xt), w, m, aux)
    return (act.from_local(y, mesh, rep),
            None if loss is None else act.from_local(loss, mesh, rep))


def _ep_forward(xt, p, m, mesh, data_axes, model_axis, aux):
    """Expert parallelism, the reference's ``shard_map`` branch.

    Each rank: tokens (T / n_data, d) of its data shard, the router
    replicated, experts ``[index(model) * n_local, +n_local)`` with their
    d_model dim gathered over the data axes when FSDP-sharded; capacity
    ``max(ceil(t_local * k * cf / E), 4)`` per shard, not the
    ``mesh=None`` capacity.  ``y`` is summed over 'model', the aux loss
    averaged over the data axes.  Gradients leave the region as the
    transpose of ``shard_map`` makes them: a weight replicated inside it
    summed over the axes it is replicated on (``Partial``), the tokens'
    summed over 'model'.
    """
    from torch.distributed.tensor import Partial, Shard

    names = tuple(mesh.axis_names)
    n_model = mesh.shape[model_axis]
    n_data = int(np.prod([mesh.shape[a] for a in data_axes]))
    assert m.n_experts % n_model == 0, (m.n_experts, n_model)
    n_local = m.n_experts // n_model
    t_local = xt.shape[0] // n_data
    cap = max(int(np.ceil(t_local * m.top_k * m.capacity_factor
                          / m.n_experts)), 4)

    def pl(**dims):
        return placements_by_axis(mesh, dims)

    tok = {a: Shard(0) for a in data_axes}
    x_pl = pl(**tok)
    x_l = act.to_local(xt, mesh, x_pl, pl(**tok, **{model_axis: Partial()}))
    router = act.to_local(p["router"], mesh, pl(),
                          pl(**{a: Partial() for a in names}))

    def expert(w):
        # experts over 'model'; a d_model dim FSDP-sharded over the data
        # axes is gathered here (the reference's all_gather), and each
        # data shard's tokens add their own term to the gradient
        return act.to_local(w, mesh, pl(**{model_axis: Shard(0)}),
                            pl(**{model_axis: Shard(0)},
                               **{a: Partial() for a in data_axes}))

    w_gate, w_up, w_down = (expert(p[k]) for k in ("w_gate", "w_up",
                                                   "w_down"))
    idx, gate, aux_l = _route(x_l, router, m, aux)
    e_lo = mesh.coordinate()[model_axis] * n_local
    y_l = _dispatch_compute(x_l, idx, gate, w_gate, w_up, w_down, e_lo,
                            n_local, cap)
    # psum over 'model': each model rank holds its experts' partial sum
    y = act.from_local(y_l, mesh, pl(**tok, **{model_axis: Partial()}))
    y = y.redistribute(mesh.device_mesh, x_pl)
    if aux_l is None:
        return y, None
    # pmean over the data axes; every model rank holds the same value, so
    # each carries 1/n_model of it (the cotangent shard_map gives it)
    loss = act.from_local(aux_l / (n_data * n_model), mesh,
                          pl(**{a: Partial() for a in names}))
    return y, loss.redistribute(mesh.device_mesh, pl())
