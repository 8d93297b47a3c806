"""Continuous-batching reservoir serving on the PyTorch/CUDA port: queue ->
slots -> chunked rollout.

The twin of ``examples/serve_async.py`` on ``repro_torch``.  Simulates a
Poisson stream of variable-length prediction requests against a trained
reservoir and serves it two ways:

* **one-shot** — ``ReservoirEngine.submit_many``: wait until the whole
  request list exists, pad it into buckets, roll, answer.
* **continuous** — ``AsyncReservoirServer``: a fixed pool of batch slots,
  the engine rolled in ``chunk_steps`` segments, each live slot's
  reservoir state carried between chunks, finished sequences retired and
  queued ones admitted mid-flight.

Both produce identical predictions; the point is the clock.  The report
prints goodput (useful reservoir steps per second of makespan, measured
from the first arrival), queue waits, time-to-first-prediction and slot
occupancy.

Departures from the reference script: ``--backend`` takes ``torch`` (the
reference's ``xla``) and ``cuda`` (its ``pallas``); ``--device`` (default
``cuda``; ``--device cpu`` runs the kernels' plain PyTorch twins); the
calibration chunk is timed to a device synchronisation where the
reference blocks on its result (timing the enqueue alone would make the
Poisson gaps shorter than a chunk really takes).

Run:  python examples/serve_async_torch.py
      python examples/serve_async_torch.py --dim 512 --slots 16
      python examples/serve_async_torch.py --backend cuda
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np
import torch

from repro_torch.core.esn import (ESNConfig, fit_readout, init_esn,
                                  run_reservoir)
from repro_torch.serve import (AsyncReservoirServer, PaddingBucketer,
                               ReservoirEngine, ServeStats, SubmitSpec)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "torch", "cuda"])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--chunk-steps", type=int, default=16)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--utilization", type=float, default=0.8,
                    help="arrival rate as a fraction of service rate")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ESNConfig(reservoir_dim=args.dim, element_sparsity=0.85,
                    output_dim=2, seed=0)
    params = init_esn(cfg, device=args.device)
    dev = params.device
    rng = np.random.default_rng(0)
    train_u = torch.as_tensor(rng.standard_normal((400, 1)),
                              dtype=torch.float32, device=dev)
    states = run_reservoir(params, train_u, engine="scan")
    targets = torch.cat([train_u, torch.roll(train_u, 1)], dim=-1)
    params = fit_readout(params, states, targets, lam=1e-2)
    engine = ReservoirEngine(params, backend=args.backend, stats=ServeStats())

    lengths = rng.integers(8, 97, args.requests)
    reqs = [SubmitSpec(rng.standard_normal((int(t), 1)).astype(np.float32),
                       uid=i)
            for i, t in enumerate(lengths)]
    total_steps = int(lengths.sum())

    # Poisson arrivals calibrated against one measured pool chunk.  The
    # warmup sets up the exact chunk the scheduler runs (predictions +
    # carried final state at the pool shape).
    warm = torch.as_tensor(
        rng.standard_normal((args.slots, args.chunk_steps, 1)),
        dtype=torch.float32, device=dev)
    warm_x0 = torch.zeros((args.slots, args.dim), dtype=torch.float32,
                          device=dev)
    engine.run_segment(warm, warm_x0)
    _sync(dev)                                               # set up
    t0 = time.perf_counter()
    engine.run_segment(warm, warm_x0)
    _sync(dev)
    t_chunk = time.perf_counter() - t0
    service_rate = args.slots * args.chunk_steps / t_chunk
    mean_gap = float(np.mean(lengths)) / (args.utilization * service_rate)
    arrivals = np.cumsum(rng.exponential(mean_gap, args.requests))
    arrivals -= arrivals[0]
    print(f"{args.requests} requests, {total_steps} steps total, arrivals "
          f"spread over {arrivals[-1] * 1e3:.1f} ms "
          f"(~{args.utilization:.0%} of service rate)")

    # -- one-shot: the batch exists only after the last arrival ------------
    bucketer = PaddingBucketer(len_buckets=(16, 32, 64, 96),
                               batch_buckets=(1, 2, 4, 8))
    engine.submit_many(reqs, bucketer=bucketer)              # warmup
    t0 = time.perf_counter()
    res_one = engine.submit_many(reqs, bucketer=bucketer)
    makespan_one = float(arrivals[-1]) + time.perf_counter() - t0

    # -- continuous: admit on arrival, chunk, retire, repeat ---------------
    srv = AsyncReservoirServer(engine, n_slots=args.slots,
                               chunk_steps=args.chunk_steps,
                               stats=ServeStats())
    handles = [srv.submit(r, arrival_time=float(at))
               for r, at in zip(reqs, arrivals)]
    res_cont = srv.run()
    makespan_cont = srv.now

    for uid, out in res_cont.items():
        np.testing.assert_allclose(
            torch.as_tensor(out.output).cpu().numpy(),
            torch.as_tensor(res_one[uid].output).cpu().numpy(),
            rtol=1e-4, atol=1e-6)
    print(f"\nboth paths served {len(res_cont)} requests with matching "
          f"predictions (backend={engine.backend})")
    print(f"  one-shot   : {total_steps / makespan_one:9.0f} steps/s goodput "
          f"({makespan_one * 1e3:.1f} ms makespan)")
    print(f"  continuous : {total_steps / makespan_cont:9.0f} steps/s goodput "
          f"({makespan_cont * 1e3:.1f} ms makespan, "
          f"{makespan_one / makespan_cont:.2f}x)")
    print("\nqueue stats:", srv.stats.render())
    worst = max(handles, key=lambda q: q.first_output_time - q.arrival_time)
    print(f"worst time-to-first-prediction: request {worst.uid} "
          f"({(worst.first_output_time - worst.arrival_time) * 1e3:.2f} ms "
          f"after arrival)")
    print("OK")
    return {"engine": engine, "server": srv, "one_shot": res_one,
            "continuous": res_cont}


if __name__ == "__main__":
    main()
