"""A configuration's weights, made from the seed on the device.

The dense reservoir matrix is a Bernoulli-sparse uniform(-1, 1) draw
rescaled to the configuration's spectral radius; ``W_in`` is
uniform(-input_scale, input_scale) and the readout ``W_out`` is drawn
normal(0, 1 / dim): serving a drawn readout costs what serving a fitted
one does, and fitting is training.  Made with one ``torch.Generator`` on
the device in a few large calls; the program and the reference are both
handed these same arrays, and each derives the rest itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Weights", "make_weights"]


@dataclasses.dataclass
class Weights:
    dense: np.ndarray       # (R, R) float64, the rescaled reservoir matrix
    w_in: np.ndarray        # (I, R) float32
    w_out: np.ndarray       # (R, O) float32
    nnz: int                # nonzeros of ``dense``


def make_weights(cfg: dict, seed: int, device) -> Weights:
    dim, i, o = cfg["reservoir_dim"], cfg["input_dim"], cfg["output_dim"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    vals = torch.rand((dim, dim), generator=g, device=device,
                      dtype=torch.float64) * 2.0 - 1.0
    keep = torch.rand((dim, dim), generator=g, device=device,
                      dtype=torch.float64) >= cfg["element_sparsity"]
    m = vals * keep
    try:
        rho = float(torch.linalg.eigvals(m).abs().max())
    except (RuntimeError, NotImplementedError):
        # a build without a device eigensolver: the same matrix on the host
        rho = float(np.abs(np.linalg.eigvals(m.cpu().numpy())).max())
    dense = m * (cfg["spectral_radius"] / rho)
    s = cfg["input_scale"]
    w_in = (torch.rand((i, dim), generator=g, device=device) * 2.0 - 1.0) * s
    w_out = torch.randn((dim, o), generator=g, device=device) / dim ** 0.5
    return Weights(dense=dense.cpu().numpy(),
                   w_in=w_in.cpu().numpy().astype(np.float32),
                   w_out=w_out.cpu().numpy().astype(np.float32),
                   nnz=int(keep.sum()))
