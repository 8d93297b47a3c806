"""Device selection shared by every entry point of the port.

Entry points run on the GPU unless the caller asks for the CPU: with no
``device`` they resolve to ``cuda``, and they raise when no CUDA device is
present instead of carrying on quietly on the CPU.  ``device="cpu"`` runs
the plain PyTorch twins of the kernels (what the CPU tests use).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (the current CUDA device, with its index);
    raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path explicitly")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
