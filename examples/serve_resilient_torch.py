"""Production hardening end to end on the PyTorch/CUDA port: backpressure,
chaos, and grow-back.

The twin of ``examples/serve_resilient.py`` on ``repro_torch``.  Two acts
on the deterministic virtual clock:

1. **Overload + backpressure** (single device): a 3x-oversubscribed
   Poisson trace hits an :class:`~repro_torch.serve.admission.AdmissionPolicy`
   stack — bounded queue depth, deadline shedding off the calibrated
   cost model's queue-delay estimate — and every refusal is an explicit
   ``RolloutResult(status="rejected")`` with a retry-after hint, while
   the admitted requests keep a bounded p99.  The same trace without
   admission control shows the unbounded queue's latency blow-up.

2. **Chaos + elastic grow-back** (4 shards): a sharded server runs a
   seeded :class:`~repro_torch.runtime.faults.FaultPlan` — transient
   engine-call failures (retried with backoff, bit-identical replay),
   straggler windows, and a shard death mid-trace.  The death drains
   into the elastic ``shrink()`` path, the
   :class:`~repro_torch.runtime.elastic.AutoscalePolicy` grows the pool
   back under the backlog, and every completed request is checked
   bit-identical against an undisturbed run.

Departures from the reference script: the reference spreads its shards
over 8 virtual CPU devices; here every shard is placed on the one device
(``--device``, default ``cuda``: the shards take turns on the card;
``--device cpu`` runs the kernels' plain PyTorch twins), so the pool is
not bounded by a device count.

Run:  python examples/serve_resilient_torch.py
      python examples/serve_resilient_torch.py --requests 96
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
from repro_torch.runtime.elastic import AutoscalePolicy
from repro_torch.runtime.faults import FaultEvent, FaultPlan
from repro_torch.serve import (AsyncReservoirServer, ReservoirEngine,
                               ServeStats, SubmitSpec, default_policy)


def _trained_params(dim, device, seed=0):
    cfg = ESNConfig(reservoir_dim=dim, element_sparsity=0.85, output_dim=2,
                    seed=seed)
    params = init_esn(cfg, device=device)
    rng = np.random.default_rng(seed)
    train_u = torch.as_tensor(rng.standard_normal((400, 1)),
                              dtype=torch.float32, device=params.device)
    states = run_reservoir(params, train_u, engine="scan")
    targets = torch.cat([train_u, torch.roll(train_u, 1)], dim=-1)
    return fit_readout(params, states, targets, lam=1e-2)


def _trace(n, seed, mean_gap):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(16, 65, n)
    specs = [SubmitSpec(rng.standard_normal((int(t), 1)).astype(np.float32),
                        uid=i)
             for i, t in enumerate(lengths)]
    at = np.cumsum(rng.exponential(mean_gap, n))
    return specs, at - at[0]


def _play(srv, specs, arrivals):
    """Submit each request when the virtual clock reaches its arrival."""
    i, n = 0, len(specs)
    while i < n or not srv.drained:
        while i < n and (arrivals[i] <= srv.now or srv.drained):
            srv.submit(specs[i], arrival_time=float(arrivals[i]))
            i += 1
        srv.step()
    return srv.results


def act_one_backpressure(params, n_req):
    print("=" * 66)
    print("Act 1: overload at ~3x service rate, backpressure on vs off")
    print("=" * 66)
    n_slots, chunk_steps = 4, 16
    # ~40-step requests through a 4x16 pool at 1 tick/chunk: service
    # rate ~1.6 req/tick; a 3x-oversubscribed trace arrives ~4.8/tick
    specs, at = _trace(n_req, seed=1, mean_gap=0.21)
    servers = {}
    for label, admission in (("backpressure ON ",
                              default_policy(max_depth=8)),
                             ("backpressure OFF", None)):
        eng = ReservoirEngine(params, stats=ServeStats())
        srv = AsyncReservoirServer(eng, n_slots=n_slots,
                                   chunk_steps=chunk_steps, chunk_time=1.0,
                                   stats=ServeStats(), admission=admission)
        res = _play(srv, specs, at)
        done = [r for r in res.values()
                if getattr(r, "status", "ok") == "ok"]
        lat = sorted(r.timings["latency_s"] for r in done)
        p99 = lat[int(0.99 * (len(lat) - 1))]
        st = srv.stats
        print(f"  {label}: {st.completed} served, {st.rejected} rejected, "
              f"{st.shed} shed | p99 latency {p99:5.1f} ticks "
              f"(makespan {srv.now:.0f})")
        if admission is not None:
            sample = next(r for r in res.values()
                          if getattr(r, "status", "ok") == "rejected")
            print(f"    a rejection is explicit: status={sample.status!r}, "
                  f"reason={sample.timings['reason']!r}, "
                  f"retry_after_s={sample.timings['retry_after_s']:.1f}")
        servers[label.strip()] = srv
    print()
    return servers


def act_two_chaos(params, n_req):
    print("=" * 66)
    print("Act 2: chaos trace — transients, stragglers, shard death, "
          "grow-back")
    print("=" * 66)
    n_shards, sps, chunk_steps = 4, 2, 16
    specs, at = _trace(n_req, seed=2, mean_gap=0.35)
    loss_at = float(at[-1]) * 0.4
    # the pool on one device: every shard in turn on its stream
    devices = [params.device] * n_shards

    def serve(plan, autoscale):
        eng = ShardedReservoirEngine(params,
                                     mesh=make_data_mesh(devices=devices),
                                     stats=ServeStats())
        srv = DistributedReservoirServer(
            eng, slots_per_shard=sps, chunk_steps=chunk_steps,
            chunk_time=1.0, stats=ServeStats(), fault_plan=plan,
            autoscale=autoscale, devices=devices)
        res = _play(srv, specs, at)
        return res, srv

    plan = FaultPlan([
        FaultEvent("transient", at=1.0, count=2),
        FaultEvent("slow_shard", at=3.0, factor=3.0, duration=2.0),
        FaultEvent("shard_loss", at=loss_at, shard=1),
    ], backoff_base_s=1 / 64)
    chaos, srv = serve(plan, AutoscalePolicy(min_shards=1,
                                             max_shards=n_shards,
                                             cooldown_steps=2))
    print(f"  injected: {plan.injected} "
          f"(shard death at tick {loss_at:.0f})")
    print(f"  recovered: {srv.reshards} reshard(s) + {srv.grows} grow(s), "
          f"{srv.readmitted} sequences re-admitted with carried state, "
          f"{srv.stats.retries} retried engine calls")
    print(f"  served {srv.stats.completed}/{n_req}, "
          f"lost {srv.stats.enqueued - srv.stats.completed - srv.stats.timed_out}")

    ref, ref_srv = serve(None, None)
    for uid, r in chaos.items():
        np.testing.assert_array_equal(
            torch.as_tensor(r.output).cpu().numpy(),
            torch.as_tensor(ref[uid].output).cpu().numpy())
    print(f"  every completed request is BIT-IDENTICAL to the undisturbed "
          f"run (makespan {srv.now:.0f} vs {ref_srv.now:.0f} ticks)")
    print()
    return {"chaos": srv, "undisturbed": ref_srv}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    params = _trained_params(args.dim, args.device)
    one = act_one_backpressure(params, args.requests)
    two = act_two_chaos(params, args.requests)
    print("OK")
    return {**one, **two}


if __name__ == "__main__":
    main()
