"""Reservoir serving end to end on the PyTorch/CUDA port: compile -> plan
-> execute.

The twin of ``examples/serve_reservoir.py`` on ``repro_torch``.  Builds a
frozen reservoir (the paper's workload), trains its ridge readout, and
serves a stream of variable-length rollout requests through the fused
batched engine — which answers with *predictions* (``W_out`` fused into
the rollout's epilogue), not state trajectories.  Prints the shared
ExecutionPlan's compile/cost summary (what was culled, how the rollout
bands under the on-chip budget, the paper's FPGA numbers) and the
throughput/padding statistics.

Departures from the reference script: ``--backend`` takes ``torch`` (the
per-step PyTorch loop, the reference's ``xla``) and ``cuda`` (the rollout
kernels, the reference's ``pallas``); ``--device`` (default ``cuda``;
``--device cpu`` runs the kernels' plain PyTorch twins); the timed calls
end in a device synchronisation where the reference blocks on its result.

Run:  python examples/serve_reservoir_torch.py --dim 512
      python examples/serve_reservoir_torch.py --mode int8-csd
      python examples/serve_reservoir_torch.py --backend cuda
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np
import torch

from repro_torch.core.esn import (ESNConfig, fit_readout, init_esn, predict,
                                  run_reservoir)
from repro_torch.launch.report import plan_table
from repro_torch.serve import (PaddingBucketer, ReservoirEngine,
                               RolloutRequest, ServeStats, SubmitSpec)


def _sync(x, device):
    """``x`` once the device has finished it (the reference's
    ``jax.block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return x


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--mode", default="fp32",
                    choices=["fp32", "int8-pn", "int8-csd"])
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "torch", "cuda"])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ESNConfig(reservoir_dim=args.dim, element_sparsity=0.85,
                    mode=args.mode, seed=0)
    params = init_esn(cfg, device=args.device)
    dev = params.device

    # one shared compile: the plan below feeds every backend and the report
    plan = params.w.plan()
    print("=== ExecutionPlan (compile once, execute everywhere) ===")
    print(plan.describe())
    print(plan_table([plan]))

    # train the readout on a short teacher signal, then serve predictions
    rng = np.random.default_rng(0)
    train_u = torch.as_tensor(rng.standard_normal((400, 1)),
                              dtype=torch.float32, device=dev)
    states = run_reservoir(params, train_u, engine="scan")
    targets = torch.cat([train_u, torch.roll(train_u, 1)], dim=-1)
    params = fit_readout(params, states, targets, lam=1e-2)

    engine = ReservoirEngine(params, backend=args.backend,
                             stats=ServeStats())
    reqs = [RolloutRequest(
                uid=i,
                inputs=rng.standard_normal(
                    (int(rng.integers(8, args.max_len + 1)), 1)
                ).astype(np.float32))
            for i in range(args.requests)]
    bucketer = PaddingBucketer(len_buckets=(16, 32, 64, 128),
                               batch_buckets=(1, 2, 4, 8, 16))

    results = {uid: r.output for uid, r in
               engine.submit_many(
                   [SubmitSpec(q.inputs, uid=q.uid) for q in reqs],
                   bucketer=bucketer).items()}           # predictions!
    print(f"\nserved {len(results)} rollout requests -> predictions "
          f"(dim={args.dim}, mode={args.mode}, backend={engine.backend})")
    print("serve stats:", engine.stats.render())

    # spot-check one request against predict() over the per-step scan
    probe = reqs[0]
    want = predict(params, run_reservoir(
        params, torch.as_tensor(probe.inputs, device=dev),
        engine="scan")).cpu().numpy()
    got = torch.as_tensor(results[probe.uid]).cpu().numpy()
    assert got.shape == (probe.length, 2), got.shape
    err = np.abs(got - want).max()
    assert err < 1e-3, err
    print(f"parity vs scan+predict baseline: max |diff| = {err:.2e}")

    # same requests, states contract: one SubmitSpec field away
    specs = [SubmitSpec(r.inputs, uid=r.uid, want_states=True)
             for r in reqs[:2]]
    states_res = engine.submit_many(specs, bucketer=bucketer)
    assert states_res[0].states.shape == (reqs[0].length, args.dim)

    # single-shot latency: fused-readout serve vs states-then-matmul
    u = torch.as_tensor(rng.standard_normal((8, 64, 1)),
                        dtype=torch.float32, device=dev)
    timings = {}
    for name, fn in (
            ("two-pass", lambda: _sync(
                predict(params, engine.rollout(u)), dev)),
            ("fused", lambda: _sync(engine.predictions(u), dev))):
        fn()  # warmup
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        timings[name] = dt
        print(f"  {name:8s}: {8 * 64 / dt:9.0f} steps/s "
              f"({dt * 1e3:.1f} ms for 8x64)")
    print("OK")
    return {"engine": engine, "results": results, "timings": timings}


if __name__ == "__main__":
    main()
