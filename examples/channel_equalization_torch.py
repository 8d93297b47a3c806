"""Nonlinear channel equalization with an ESN on the PyTorch/CUDA port.

The twin of ``examples/channel_equalization.py`` on ``repro_torch`` — the
task of paper ref [3].  A 4-PAM symbol stream is distorted by a multipath
channel with a memoryless nonlinearity and additive noise; the reservoir
recovers the transmitted symbol (delay 2).  Reports symbol error rate
(SER) for fp32 and for the paper's int8+CSD fixed-point reservoir, plus
the FPGA cost of the deployed matrix.  Both rollouts run through the
specialized rollout kernel on the card.

Departures from the reference script: ``--device`` (default ``cuda``;
``--device cpu`` runs the kernels' plain PyTorch twins), and a closing
``OK`` line.

Run:  python examples/channel_equalization_torch.py
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np
import torch

from repro_torch.core.esn import (ESNConfig, fit_readout, init_esn, predict,
                                  run_reservoir)
from repro_torch.data.pipeline import channel_equalization

SYMBOLS = np.array([-3.0, -1.0, 1.0, 3.0])


def ser(pred, target):
    pred = np.asarray(pred).ravel()
    snap = SYMBOLS[np.argmin(np.abs(pred[:, None] - SYMBOLS[None, :]), axis=1)]
    return float((snap != np.asarray(target).ravel()).mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n = 6000
    u, d = channel_equalization(n, seed=0, snr_db=28.0)
    u = (u / np.abs(u).max()).astype(np.float32)
    split = 4000

    # per-mode hyperparameters from a small validation sweep
    hp = {"fp32": dict(input_scale=0.3, leak=0.3, spectral_radius=0.8),
          "int8-csd": dict(input_scale=1.0, leak=0.6, spectral_radius=0.85)}
    out = {}
    for mode in ("fp32", "int8-csd"):
        cfg = ESNConfig(reservoir_dim=600, element_sparsity=0.85, mode=mode,
                        seed=3, **hp[mode])
        p = init_esn(cfg, device=args.device)
        inputs = torch.as_tensor(u[:, None], device=p.device)
        states = run_reservoir(p, inputs)
        p = fit_readout(p, states[200:split],
                        torch.as_tensor(d[200:split, None], device=p.device),
                        lam=1e-5)
        test = ser(predict(p, states[split:])[:, 0].cpu(), d[split:])
        cost = p.w.fpga_cost()
        print(f"{mode:9s} SER={test:.4f}  | deployed matrix: "
              f"{p.w.ones} ones, {cost.latency_ns:.0f} ns/symbol, "
              f"{cost.power_w:.1f} W")
        assert test < 0.2  # chance = 0.75
        out[mode] = {"params": p, "u": inputs, "states": states,
                     "ser": test}
    print("OK")
    return out


if __name__ == "__main__":
    main()
