"""Quickstart on the PyTorch/CUDA port: the paper end to end on one GPU.

The twin of ``examples/quickstart.py`` on ``repro_torch``.  Builds the
paper's workload — an Echo State Network whose fixed sparse reservoir is
"compiled" offline (int8 quantization -> CSD digit planes -> block-culled
structure) — trains the ridge readout on Mackey-Glass prediction, and
prints the FPGA cost-model report for the exact matrix the reservoir
uses, i.e. the numbers Figs 10-12 of the paper are made of.  The rollout
and the served predictions run through the specialized rollout kernel
(its readout fused) on the card.

Departures from the reference script: ``--device`` (default ``cuda``;
``--device cpu`` runs the kernels' plain PyTorch twins), and a closing
``OK`` line.

Run:  python examples/quickstart_torch.py
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np
import torch

from repro_torch.core import baselines
from repro_torch.core.esn import (ESNConfig, fit_readout, init_esn, nrmse,
                                  predict, run_readout, run_reservoir)
from repro_torch.data.pipeline import mackey_glass


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("=== reservoir: fixed sparse matrix, compiled offline ===")
    cfg = ESNConfig(reservoir_dim=800, element_sparsity=0.75,  # [5] baseline
                    mode="int8-csd", seed=0)
    params = init_esn(cfg, device=args.device)
    # The one shared compile step every consumer (kernels, serving, cost
    # reports) builds from — the counterpart of the paper's synthesis run.
    plan = params.w.plan()
    print(plan.describe())
    cost = plan.fpga_cost()
    gpu = baselines.gpu_latency_s(1024, 0.75, "cusparse")
    print(f"vs modeled V100 cuSPARSE gemv: {gpu * 1e6:.2f} us "
          f"({gpu / cost.latency_s:.0f}x)")

    print("\n=== task: Mackey-Glass one-step prediction ===")
    sig = mackey_glass(3000, seed=0)
    u = torch.as_tensor(sig[:-1, None], device=params.device)
    y = torch.as_tensor(sig[1:, None], device=params.device)
    states = run_reservoir(params, u)
    params = fit_readout(params, states[500:2000], y[500:2000], lam=1e-6)
    train_err = float(nrmse(predict(params, states[500:2000]),
                            y[500:2000]))
    # serving path: predictions straight from the fused rollout + readout
    preds = run_readout(params, u)
    test_err = float(nrmse(preds[2000:], y[2000:]))
    print(f"NRMSE train={train_err:.4f}  test={test_err:.4f} "
          f"(int8+CSD arithmetic, same digit planes the FPGA would burn in; "
          f"test predictions served by the fused readout path)")
    assert np.isfinite(test_err)
    print("OK")
    return {"params": params, "u": u, "states": states, "preds": preds}


if __name__ == "__main__":
    main()
