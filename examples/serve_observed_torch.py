"""Observed serving on the PyTorch/CUDA port: metrics, request traces and
the set-up event log.

The twin of ``examples/serve_observed.py`` on ``repro_torch``.  Runs the
continuous-batching server from ``serve_async_torch.py`` with the
observability layer switched on (``repro_torch.obs`` is a no-op until
``obs.configure()`` is called) and shows what each sink buys you:

* **metrics** — counters and fixed-bucket latency histograms; the
  summary prints exact p50/p99/p999 queue-wait, time-to-first-prediction
  and end-to-end latency, and the same registry renders a
  Prometheus-format scrape payload;
* **tracing** — every request threads a ``trace_id`` through its
  lifecycle spans (enqueue -> queued -> first_output -> serve), so one
  slow request can be reconstructed stage by stage from the flight
  recorder, which is also dumped as JSONL for offline digging;
* **events** — set-up facts: the engine emits one ``rollout_setup`` the
  first time it runs a rollout of a new (shape, outputs, schedule) key.
  Those at warmup are expected; a new one under steady traffic means the
  warmup missed a shape, and it prints as a count you can alert on.

Departures from the reference script: the port builds no program per
shape, so where the reference counts its compile events (``xla_trace``,
``pallas_trace``) at warmup and ``retrace`` events under traffic, the
twin counts ``rollout_setup`` events at warmup and the new ones under
traffic, with the same "steady state held" check; ``--backend`` takes
``torch`` (the reference's ``xla``) and ``cuda`` (its ``pallas``);
``--device`` (default ``cuda``; ``--device cpu`` runs the kernels' plain
PyTorch twins); the calibration chunk is timed to a device
synchronisation where the reference blocks on its result.

Run:  python examples/serve_observed_torch.py
      python examples/serve_observed_torch.py --dim 512
      python examples/serve_observed_torch.py --trace-out t.jsonl
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.esn import (ESNConfig, fit_readout, init_esn,
                                  run_reservoir)
from repro_torch.serve import (AsyncReservoirServer, ReservoirEngine,
                               ServeStats, SubmitSpec)


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
    ap.add_argument("--trace-out", default="serve_trace.jsonl",
                    help="path for the JSONL span dump")
    ap.add_argument("--metrics-out", default="serve_metrics.prom",
                    help="path for the Prometheus text payload")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # instrumentation on *before* the engine exists, so the build and
    # every set-up land in the event log
    obs.configure()

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

    # calibrated Poisson arrivals, same recipe as serve_async_torch.py
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

    setups = obs.events().count("rollout_setup")
    print(f"warmup done: {setups} rollout variants set up "
          f"(backend={engine.backend})")

    srv = AsyncReservoirServer(engine, n_slots=args.slots,
                               chunk_steps=args.chunk_steps,
                               stats=ServeStats())
    for r, at in zip(reqs, arrivals):
        srv.submit(r, arrival_time=float(at))
    results = srv.run()
    print(f"served {len(results)} requests, {total_steps} steps "
          f"in {srv.now * 1e3:.1f} ms of server time")

    # -- live metrics snapshot ---------------------------------------------
    print("\n== metrics snapshot (merged across label sets) ==")
    for name, val in sorted(obs.metrics().summary().items()):
        if isinstance(val, dict):
            print(f"  {name:28s} n={val['count']:<4d} "
                  f"p50={val['p50'] * 1e3:8.3f} ms  "
                  f"p99={val['p99'] * 1e3:8.3f} ms  "
                  f"p999={val['p999'] * 1e3:8.3f} ms")
        else:
            print(f"  {name:28s} {val:g}")

    # -- one request, reassembled from its trace ---------------------------
    slowest = max(results.values(),
                  key=lambda r: r.timings["latency_s"])
    tid = slowest.timings["trace_id"]
    print(f"\n== lifecycle of the slowest request (trace_id={tid}, "
          f"{slowest.timings['latency_s'] * 1e3:.2f} ms end to end) ==")
    for s in obs.tracer().spans(trace_id=tid):
        print(f"  {s.name:22s} {s.duration_s * 1e3:8.3f} ms "
              f"[{s.clock} clock] {s.attrs}")

    # -- set-up event ledger -----------------------------------------------
    new_setups = obs.events().count("rollout_setup") - setups
    print(f"\nset-up events: {setups} rollout set-ups at warmup, "
          f"{new_setups} new set-ups under traffic"
          + (" (steady state held)" if new_setups == 0 else "  <-- BUG"))

    # -- exports ------------------------------------------------------------
    n = obs.tracer().export_jsonl(args.trace_out)
    with open(args.metrics_out, "w") as fh:
        fh.write(obs.metrics().prometheus_text())
    print(f"dumped {n} spans to {args.trace_out} and the scrape payload "
          f"to {args.metrics_out}")
    obs.disable()
    print("OK")
    return {"engine": engine, "server": srv, "results": results,
            "setups": setups, "new_setups": new_setups}


if __name__ == "__main__":
    main()
