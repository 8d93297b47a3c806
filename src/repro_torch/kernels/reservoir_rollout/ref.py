"""Dense plain-PyTorch oracles for the fused reservoir rollout."""

from __future__ import annotations

import torch

from repro_torch.core.sparse import int_matmul_exact


def rollout_fp32_ref(u_seq, w, w_in, x0, *, leak: float = 1.0):
    """(T, B, I) inputs through a dense reservoir matrix, step by step."""
    x = x0.to(torch.float32)
    states = []
    for t in range(u_seq.shape[0]):
        pre = u_seq[t].to(torch.float32) @ w_in + x @ w
        x = (1.0 - leak) * x + leak * torch.tanh(pre)
        states.append(x)
    return torch.stack(states)


def rollout_int8_ref(u_seq, q, scale, w_in, x0, *, leak: float = 1.0,
                     state_bits: int = 8):
    """Exact integer-reservoir rollout: per-step state requantization.

    ``q`` is the int8 quantized reservoir matrix; the recurrent product is
    exact int32, rescaled by ``scale / smax`` — the same semantics as
    ``repro_torch.core.esn._step_int8``.
    """
    smax = (1 << (state_bits - 1)) - 1
    x = x0.to(torch.float32)
    states = []
    for t in range(u_seq.shape[0]):
        xq = torch.clamp(torch.round(x * smax), -smax - 1, smax)
        recur = int_matmul_exact(xq, q).to(torch.float32) * (scale / smax)
        pre = u_seq[t].to(torch.float32) @ w_in + recur
        x = (1.0 - leak) * x + leak * torch.tanh(pre)
        states.append(x)
    return torch.stack(states)
