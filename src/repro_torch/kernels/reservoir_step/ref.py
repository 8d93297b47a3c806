"""Plain-PyTorch oracle for the fused reservoir step."""

from __future__ import annotations

import torch


def reservoir_step_ref(x, w, u, w_in, leak: float = 1.0):
    pre = u.to(torch.float32) @ w_in.to(torch.float32) \
        + x.to(torch.float32) @ w.to(torch.float32)
    return (1.0 - leak) * x.to(torch.float32) + leak * torch.tanh(pre)
