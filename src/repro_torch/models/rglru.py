"""RG-LRU recurrent block (RecurrentGemma / Griffin).

    r_t = sigmoid(x_t W_a + b_a)            recurrence gate
    i_t = sigmoid(x_t W_x + b_x)            input gate
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

Prefill runs the linear recurrence as a log-depth scan over the sequence:
the reference's ``jax.lax.associative_scan`` has no stable PyTorch
counterpart, so ``rglru_scan`` doubles the span of each element's prefix
``ceil(log2(S))`` times (a Hillis-Steele scan of elementwise passes, not S
launches).  Its float products run in another order than XLA's; the CPU
tests state the gap.  Decode keeps O(1) state: (conv buffer, h).

Block layout (Griffin): y = W_out[ GeLU(x W_gate) * RGLRU(conv4(x W_in)) ].
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import _gelu, dense_init, zeros_init

__all__ = ["init_rglru", "rglru_scan", "rglru_block_forward",
           "rglru_block_decode", "init_state"]

_C = 8.0


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))    # jax.nn.softplus


def init_rglru(key, cfg, dtype=torch.float32, *, lead=(), device=None):
    d, r = cfg.d_model, cfg.lru_dim
    w = cfg.conv_width
    kw = dict(lead=lead, device=device)
    dev = key.device if device is None else device
    # Lambda init so softplus(Lambda) spreads decay rates (Griffin: a in
    # [0.9, 0.999] at r=1): sample uniform then invert.
    u = torch.rand(tuple(lead) + (r,), generator=key, device=dev)
    u = 0.9 + (0.999 - 0.9) * u
    lam = torch.log(torch.expm1(-torch.log(u) / _C))
    return {
        "w_in": dense_init(key, (d, r), ("embed", "lru"), 0, dtype, **kw),
        "w_gate": dense_init(key, (d, r), ("embed", "lru"), 0, dtype, **kw),
        "w_out": dense_init(key, (r, d), ("lru", "embed"), 0, dtype, **kw),
        "conv_w": dense_init(key, (w, r), (None, "lru"), 0, dtype,
                             scale=0.5, **kw),
        "conv_b": zeros_init((r,), ("lru",), dtype, lead=lead, device=dev),
        "w_a": dense_init(key, (r, r), ("lru", None), 0, dtype, **kw),
        "b_a": zeros_init((r,), (None,), dtype, lead=lead, device=dev),
        "w_x": dense_init(key, (r, r), ("lru", None), 0, dtype, **kw),
        "b_x": zeros_init((r,), (None,), dtype, lead=lead, device=dev),
        # float32 in every model dtype, as in the reference
        "lam": (lam.float(), ("layers",) * len(lead) + ("lru",)),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv, width W.  x: (B, S, r); state: (B, W-1, r)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
              for i in range(width))
    new_state = xp[:, -(width - 1):, :] if width > 1 else pad
    return out + b.to(x.dtype), new_state


def _gates(xc, p):
    r = torch.sigmoid(xc @ p["w_a"].to(xc.dtype) + p["b_a"].to(xc.dtype))
    i = torch.sigmoid(xc @ p["w_x"].to(xc.dtype) + p["b_x"].to(xc.dtype))
    log_a = (-_C * _softplus(p["lam"].float())) * r.float()
    a = torch.exp(log_a)
    gated_in = (i.float() * xc.float()
                * torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)))
    return a, gated_in


def rglru_scan(xc, p, h0=None):
    """The linear recurrence over the whole sequence, log-depth.

    xc: (B, S, r) conv output; returns (h (B, S, r) f32, h_last).
    """
    a, b = _gates(xc, p)                 # both (B, S, r) f32
    if h0 is not None:
        # fold the carried state in as a virtual step contribution
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    # inclusive scan under (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2): after
    # the pass with shift s, element t holds the prefix over (t - 2s, t]
    s = a.shape[1]
    shift = 1
    while shift < s:
        b = torch.cat([b[:, :shift],
                       a[:, shift:] * b[:, :-shift] + b[:, shift:]], dim=1)
        if 2 * shift < s:                # the last pass needs no new a
            a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]],
                          dim=1)
        shift *= 2
    return b, b[:, -1, :]


def rglru_block_forward(x, p, cfg, state=None):
    """Full-sequence Griffin recurrent block.

    state: None or dict(conv (B, W-1, r), h (B, r)).
    Returns (y (B, S, d), new_state).
    """
    gate = _gelu(x @ p["w_gate"].to(x.dtype))
    xin = x @ p["w_in"].to(x.dtype)
    conv_state = state["conv"] if state else None
    xc, conv_new = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_state)
    h0 = state["h"] if state else None
    h, h_last = rglru_scan(xc, p, h0)
    y = (gate * h.to(x.dtype)) @ p["w_out"].to(x.dtype)
    return y, {"conv": conv_new, "h": h_last}


def rglru_block_decode(x, p, cfg, state):
    """One-token step. x: (B, 1, d); state from forward/init_state."""
    gate = _gelu(x @ p["w_gate"].to(x.dtype))
    xin = x @ p["w_in"].to(x.dtype)
    xc, conv_new = _causal_conv(xin, p["conv_w"], p["conv_b"], state["conv"])
    a, b = _gates(xc, p)                                   # (B, 1, r)
    h = a[:, 0] * state["h"].float() + b[:, 0]
    y = (gate * h[:, None, :].to(x.dtype)) @ p["w_out"].to(x.dtype)
    return y, {"conv": conv_new, "h": h}


def init_state(batch, cfg, dtype=torch.float32, *, lead=(), device=None):
    lead, device = tuple(lead), resolve_device(device)
    return {
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, cfg.lru_dim),
                            dtype=dtype, device=device),
        "h": torch.zeros(lead + (batch, cfg.lru_dim), dtype=torch.float32,
                         device=device),
    }
