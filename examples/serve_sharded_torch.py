"""Sharded reservoir serving on the PyTorch/CUDA port: one FIFO, 8 shards,
a mid-flight shard loss.

The twin of ``examples/serve_sharded.py`` on ``repro_torch``.  The
reservoir matrix is fixed and replicated (the paper's premise), so
serving scale-out is pure batch-axis data parallelism:

    global FIFO ──► least-loaded admission ──► per-shard slot sub-pools
                                                  │ one rollout launch
                                                  ▼ per shard per chunk
                                        8 x (slots, chunk_steps) rollouts
                                        (zero collectives in the hot loop)

This example streams a Poisson trace of prediction requests into a
:class:`~repro_torch.dist.DistributedReservoirServer`, kills 3 shards
mid-flight, and shows the elastic path: the mesh shrinks to the
survivors, the engine rebuilds from the cached ExecutionPlan, every
in-flight sequence is re-admitted with its carried reservoir state — no
request lost, every prediction still matching the single-device engine.

Departures from the reference script: the reference spreads its shards
over 8 virtual CPU devices; here every shard is placed on the one device
(``--device``, default ``cuda``: the shards take turns on the card;
``--device cpu`` runs the kernels' plain PyTorch twins), so the shard
count is not bounded by a device count.

Run:  python examples/serve_sharded_torch.py
      python examples/serve_sharded_torch.py --shards 4 --fail 1
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np
import torch

from repro_torch.core.esn import (ESNConfig, fit_readout, init_esn,
                                  run_reservoir)
from repro_torch.dist import DistributedReservoirServer, ShardedReservoirEngine
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.serve import ReservoirEngine, ServeStats, SubmitSpec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--slots-per-shard", type=int, default=4)
    ap.add_argument("--chunk-steps", type=int, default=16)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--fail", type=int, default=3,
                    help="shards to kill mid-flight (0 disables)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ESNConfig(reservoir_dim=args.dim, element_sparsity=0.85,
                    output_dim=2, seed=0)
    params = init_esn(cfg, device=args.device)
    dev = params.device
    # N shards on one device, in turn on its stream
    devices = [dev] * args.shards
    rng = np.random.default_rng(0)
    train_u = torch.as_tensor(rng.standard_normal((400, 1)),
                              dtype=torch.float32, device=dev)
    states = run_reservoir(params, train_u, engine="scan")
    targets = torch.cat([train_u, torch.roll(train_u, 1)], dim=-1)
    params = fit_readout(params, states, targets, lam=1e-2)

    engine = ShardedReservoirEngine(params,
                                    mesh=make_data_mesh(devices=devices),
                                    stats=ServeStats())
    srv = DistributedReservoirServer(engine,
                                     slots_per_shard=args.slots_per_shard,
                                     chunk_steps=args.chunk_steps,
                                     chunk_time=1.0, stats=ServeStats(),
                                     devices=devices)
    print(f"mesh: {args.shards} data shards x {args.slots_per_shard} slots, "
          f"chunk_steps={args.chunk_steps} (virtual clock, 1 tick/chunk)")

    lengths = rng.integers(16, 97, args.requests)
    reqs = [SubmitSpec(rng.standard_normal((int(t), 1)).astype(np.float32),
                       uid=i)
            for i, t in enumerate(lengths)]
    arrivals = np.cumsum(rng.exponential(0.15, args.requests))
    arrivals -= arrivals[0]
    for r, at in zip(reqs, arrivals):
        srv.submit(r, arrival_time=float(at))
    print(f"{args.requests} requests ({int(lengths.sum())} steps) arriving "
          f"over {arrivals[-1]:.1f} ticks\n")

    # serve a few chunks, then lose shards mid-flight
    fail_after = 4
    while srv.step():
        if args.fail and srv.reshards == 0 and srv.stats.chunks >= fail_after:
            live = srv.batcher.live
            plan = srv.shrink(failed=args.fail)
            print(f"tick {srv.now:.1f}: lost {args.fail} shards with {live} "
                  f"sequences in flight")
            print(f"  replan: {plan['n_shards_before']} -> "
                  f"{plan['n_shards_after']} shards, "
                  f"{plan['readmitted']} sequences re-admitted with carried "
                  f"state")
            for act in plan["actions"]:
                print(f"    - {act}")
    res = srv.results

    # every prediction must match the single-device engine
    single = ReservoirEngine(params, stats=ServeStats())
    for r in reqs:
        want = single.predictions(torch.as_tensor(r.inputs, device=dev))
        np.testing.assert_allclose(
            torch.as_tensor(res[r.uid].output).cpu().numpy(),
            want.cpu().numpy(), rtol=1e-4, atol=1e-6)
    print(f"\nall {len(res)}/{args.requests} requests served "
          f"(reshards={srv.reshards}, re-admitted={srv.readmitted}); "
          f"predictions match the single-device engine")
    print("\nserver stats:", srv.stats.render())
    print("\nper-shard (all topology epochs):", srv.shard_summary().render())
    print("OK")
    return {"server": srv, "results": res}


if __name__ == "__main__":
    main()
