"""Device selection shared by every entry point of the port.

Entry points run on the GPU unless the caller asks for the CPU: with no
``device`` they resolve to ``cuda``, and they raise when no CUDA device is
present instead of carrying on quietly on the CPU.  ``device="cpu"`` runs
the plain PyTorch twins of the kernels (what the CPU tests use);
``device="meta"`` allocates nothing (shapes only, e.g. a parameter count).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["ieee_fp32", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (the current CUDA device, with its index);
    raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected cuda, cpu or meta")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path explicitly")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def ieee_fp32(device: torch.device):
    """fp32 products in IEEE fp32 on a CUDA device, whatever the caller set
    (TF32 would round the operands to 10 mantissa bits).  The legacy
    ``allow_tf32`` setter switches both of PyTorch's flags together, and
    the ``fp32_precision`` getter reads the caller's state without
    tripping PyTorch's check against mixing the two APIs."""
    if device.type != "cuda":
        yield
        return
    mm = torch.backends.cuda.matmul
    old = getattr(mm, "fp32_precision", None)
    old_legacy = mm.allow_tf32 if old is None else None
    mm.allow_tf32 = False
    try:
        yield
    finally:
        if old is None:
            mm.allow_tf32 = old_legacy
        elif old == "tf32":
            mm.allow_tf32 = True
        else:
            mm.fp32_precision = old
