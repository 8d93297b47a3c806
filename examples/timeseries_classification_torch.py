"""Multivariate time-series classification with reservoir states, on the
PyTorch/CUDA port ([5]).

The twin of ``examples/timeseries_classification.py`` on ``repro_torch``.
Paper ref [5] compares reservoir systems against fully-trained RNNs on
multivariate time-series classification and finds comparable quality at
a fraction of the training cost — only the linear readout is fit.  This
example reproduces that protocol on a synthetic 3-class task: each class
is a differently-parameterized 4-channel oscillator; the classifier is a
ridge readout over the reservoir's states.  The batched rollout (180
sequences) runs through the specialized rollout kernel on the card, its
batch split into tiles of at most 16 rows.

Departure from the reference script: ``--device`` (default ``cuda``;
``--device cpu`` runs the kernels' plain PyTorch twins).

Run:  python examples/timeseries_classification_torch.py
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np
import torch

from repro_torch.core.esn import ESNConfig, init_esn, run_reservoir
from repro_torch.core.ridge import ridge_fit


def make_dataset(n_per_class=60, t=120, channels=4, seed=0):
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    # class-specific frequency/coupling signatures
    freqs = [(0.9, 0.23), (0.5, 0.61), (1.4, 0.11)]
    for label, (f1, f2) in enumerate(freqs):
        for _ in range(n_per_class):
            phase = rng.uniform(0, 2 * np.pi, channels)
            tt = np.arange(t)[:, None]
            sig = (np.sin(f1 * tt / 4 + phase) +
                   0.5 * np.sin(f2 * tt / 3 + phase[::-1]) +
                   0.15 * rng.standard_normal((t, channels)))
            xs.append(sig.astype(np.float32))
            ys.append(label)
    xs = np.stack(xs)
    ys = np.asarray(ys)
    order = rng.permutation(len(ys))
    return xs[order], ys[order]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    x, y = make_dataset()
    split = 120
    cfg = ESNConfig(reservoir_dim=400, input_dim=4, element_sparsity=0.8,
                    spectral_radius=0.9, leak=0.5, mode="int8-csd", seed=1)
    p = init_esn(cfg, device=args.device)
    dev = p.device

    inputs = torch.as_tensor(x, device=dev)
    states = run_reservoir(p, inputs)  # (N, T, dim)
    # representation: per-unit mean + std over the settled half of the
    # sequence (phase-invariant — the classes differ by frequency content,
    # and samples carry random phases)
    settled = states[:, 60:, :].cpu().numpy()
    feats = np.concatenate([settled.mean(axis=1), settled.std(axis=1)],
                           axis=1)
    onehot = np.eye(3, dtype=np.float32)[y]

    w = ridge_fit(torch.as_tensor(feats[:split], device=dev),
                  torch.as_tensor(onehot[:split], device=dev), lam=1e-3)
    pred = (torch.as_tensor(feats[split:], device=dev) @ w).argmax(1)
    pred = pred.cpu().numpy()
    acc = float((pred == y[split:]).mean())
    cost = p.w.fpga_cost()
    print(f"3-class multivariate series: test accuracy = {acc:.3f} "
          f"(chance 0.333)")
    print(f"reservoir: {cfg.reservoir_dim} units, int8+CSD, "
          f"{p.w.ones} ones -> {cost.latency_ns:.0f} ns/step on XCVU13P")
    assert acc > 0.8
    print("OK")
    return {"params": p, "u": inputs, "states": states, "feats": feats,
            "w": w,
            "acc": acc}


if __name__ == "__main__":
    main()
