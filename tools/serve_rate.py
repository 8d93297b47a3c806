#!/usr/bin/env python3
"""The LARGE_1024 serving rates of ``chip_smoke.py``'s phase 3, repeated
many times, so that two trees can be compared on one card.

Run from the root of a checkout::

    python3 tools/serve_rate.py [--src DIR] [--rounds N] [--tag NAME]

It imports ``repro_torch`` from ``DIR`` (default: this checkout's
``src``), so one script times the package of another tree too, such as a
parent commit unpacked with ``git archive``.  It builds LARGE_1024 (dim
1024, int8-CSD) from its seed, fits the readout on chip_smoke's teacher
signal, makes chip_smoke's 24-request burst, and after a warm-up times
``N`` rounds of

- the burst one-shot through ``ReservoirEngine.submit_many``, and
- the burst through a 16-slot ``AsyncReservoirServer`` in 32-step chunks
  with every arrival at time 0,

each round to a device sync, by the host clock.  It prints one JSON line:
the tag, the ``repro_torch`` it imported, the card's name and power
limit, every round's requests/s and the medians.  Interleave runs of the
two trees (A, B, B, A, ...) in one machine: host-clock rates drift
within a run.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch to time")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))

    import torch
    if not torch.cuda.is_available():
        print("serve_rate: no CUDA device available", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs.esn_paper import LARGE_1024
    from repro_torch.core.esn import fit_readout, init_esn, run_reservoir
    from repro_torch.serve import (AsyncReservoirServer, ReservoirEngine,
                                   ServeStats, SubmitSpec)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # chip_smoke.py's phase 3: the same reservoir, readout and burst
    params = init_esn(LARGE_1024, device=dev)
    steps = np.arange(1200, dtype=np.float32)
    signal = (np.sin(0.2 * steps) * np.cos(0.031 * steps)
              ).astype(np.float32)[:, None]
    u_train = torch.as_tensor(signal[:-1], device=dev)
    y_train = torch.as_tensor(signal[1:], device=dev)
    params = fit_readout(params, run_reservoir(params, u_train), y_train,
                         lam=1e-4, washout=100)
    eng = ReservoirEngine(params)
    rng = np.random.default_rng(11)
    lengths = rng.integers(64, 257, size=24)
    specs = [SubmitSpec(
        signal[s:s + n] + 0.01 * rng.standard_normal((n, 1)).astype(
            np.float32), uid=i)
        for i, (n, s) in enumerate(zip(lengths, rng.integers(0, 900, 24)))]

    def one_shot():
        eng.submit_many(specs)

    def server():
        srv = AsyncReservoirServer(eng, n_slots=16, chunk_steps=32,
                                   stats=ServeStats())
        for spec in specs:
            srv.submit(spec, arrival_time=0.0)
        srv.run()

    rates = {}
    for name, fn in (("one_shot", one_shot), ("server_at_0", server)):
        for _ in range(args.warmup):
            fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rates[name] = [len(specs) / w for w in walls]
    print(json.dumps({
        "tag": args.tag, "repro_torch": repro_torch.__file__,
        "card": card(), "requests_per_burst": len(specs),
        **{f"median_{k}": statistics.median(v) for k, v in rates.items()},
        **{f"{k}_requests_per_s": v for k, v in rates.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
