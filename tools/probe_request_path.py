#!/usr/bin/env python3
"""Split the engine's host time per request of a benchmark cell around the
rollout kernel, from the port's own spans on the device trace's clock, and
time what tracing costs when it is on.

Run from the root of a checkout, on a card::

    python3 tools/probe_request_path.py --workload <cell> --seed <n>
        [--seconds 20] [--pairs 2] [--pair-seconds 5]

One process builds the cell's program as ``bench/run.py`` does (the
seed's weights, ``ReservoirEngine(backend="auto")``, the warm-up), then:

1. **split**: one window of ``--seconds`` under the benchmark's device
   trace and its own spans, with ``repro_torch.obs`` tracing
   (``obs.configure(metrics=False, events=False, trace_capacity=65536)``).
   Per request: ``submit_lead_us`` (the rollout kernel's device start
   less ``request.serve``'s start), ``submit_tail_us`` (``request.serve``'s
   end less the kernel's end), ``launch_enqueue_us`` (``rollout.launch``),
   the pieces between (``bench/spans.py``), the benchmark's own idle under
   ``submit`` per request beside lead + tail, and the idle gaps named by
   the innermost span, the benchmark's and the program's together.
2. **cost**: ``--pairs`` x (off, on, on, off) windows of
   ``--pair-seconds`` each with tracing off and on, first under the
   device trace (``engine_overhead_us``, and the median over requests of
   the idle from ``submit`` to the copy's end) and then without it
   (``steps_per_s``); tracing's cost is the difference, in us a request.
3. **host ops**: pieces of that path timed alone, ``--reps`` times each
   (medians): the inputs' copy, x0, the launch's checks, grid lookup and
   allocations, and a one-step ``submit`` with tracing off and on in
   turns (``host_ops``).

It prints one JSON line with the card's name and power limit.
The correctness check is ``bench/run.py``'s; this probe judges no answer.
Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPLIT_CAPACITY = 65536


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def window(engine, traffic, seconds, device, *, traced, observed):
    """One measured window as the benchmark drives it; with ``traced``
    the device trace and the benchmark's spans, with ``observed`` the
    program's spans.  Returns (window, device trace, program spans)."""
    from repro_torch import obs

    from bench import drive, spans
    tracer = spans.LaunchTrace(device) if traced else None
    if observed:
        obs.configure(metrics=False, events=False,
                      trace_capacity=SPLIT_CAPACITY)
    gc.collect()
    gc.freeze()
    if tracer is not None:
        tracer.start()
    w = drive.drive_engine(engine, traffic, seconds,
                           spans=[] if traced else None)
    if tracer is not None:
        tracer.stop()
    else:
        import torch
        torch.cuda.synchronize(device)
    gc.unfreeze()
    prog = (spans.program_spans(obs.tracer(), w.t_open, w.t_last)
            if observed else None)
    obs.disable()
    return w, tracer, prog


def _view(cell, w, tracer):
    from bench.harness import RunView
    return RunView(cell=cell, window=w, trace=tracer, setup_s=0.0, nnz=0,
                   kept_blocks=0, arith="")


def split(cell, w, tracer, prog) -> dict:
    """The split of one traced, observed window, on the device trace
    re-anchored launch by launch (``bench/spans.py``); ``raw`` repeats
    the per-request numbers on the trace's one offset."""
    from bench import spans
    from bench.devtrace import attribute_gaps, clip, idle_gaps
    from bench.harness import metric_reader
    view = _view(cell, w, tracer)
    raw = view.device_ops()
    full, drift = spans.reanchor(tracer.ops, tracer.launches)
    ops = clip(full, w.t_open, w.t_last)
    n = len(w.done)
    gaps = idle_gaps(full, w.t_open, w.t_last)
    bench_gaps = attribute_gaps(gaps, w.spans)
    raw_gaps = attribute_gaps(idle_gaps(tracer.ops, w.t_open, w.t_last),
                              w.spans)
    inner = spans.attribute_innermost(gaps, w.spans + (prog or []))
    reqs = spans.requests(prog, ops) if prog is not None else None
    out = {
        "requests": n,
        "spans": None if prog is None else len(prog),
        "paired": None if reqs is None else len(reqs),
        "paired_raw": (None if prog is None
                       or spans.requests(prog, raw) is None
                       else len(spans.requests(prog, raw))),
        "offset_check_us": tracer.offset_check_us,
        "drift": drift,
        "engine_overhead_us": metric_reader("engine_overhead_us")(view),
        "device_idle_pct": metric_reader("device_idle_pct")(view),
        "submit_idle_us": bench_gaps.get("submit", 0) / 1e3 / n,
        "copy_idle_us": bench_gaps.get("copy", 0) / 1e3 / n,
        "raw_submit_copy_idle_us": [raw_gaps.get("submit", 0) / 1e3 / n,
                                    raw_gaps.get("copy", 0) / 1e3 / n],
        "submit_lead_us": spans.submit_lead_us(prog, ops),
        "submit_tail_us": spans.submit_tail_us(prog, ops),
        "launch_enqueue_us": spans.launch_enqueue_us(prog, ops),
        "raw": [spans.submit_lead_us(prog, raw),
                spans.submit_tail_us(prog, raw)],
        "idle_gaps_s": {k: v / 1e9 for k, v in sorted(
            inner.items(), key=lambda kv: -kv[1])},
        "idle_gaps_total_s": [sum(inner.values()) / 1e9,
                              sum(bench_gaps.values()) / 1e9],
    }
    if reqs is not None and len(reqs) == n:
        out["pieces_us"] = pieces(prog, reqs, w.spans)
        idle = out["submit_idle_us"]
        both = out["submit_lead_us"] + out["submit_tail_us"]
        out["lead_plus_tail_vs_submit_idle_us"] = [both, idle]
        out["agrees"] = abs(both - idle) <= max(0.05 * idle, 15.0)
    return out


def pieces(prog, reqs, bench_spans) -> dict:
    """Mean us per request of each stretch of the benchmark's ``submit``
    span, in order: the call to ``request.serve``'s start, its start to
    prepare, prepare, prepare to launch, launch, the launch's return to
    the kernel's device start (negative: the kernel starts before the
    launch call returns), the kernel, the kernel's end to the sync's
    return, the sync's return to the root's end, and the root's end to
    the call's return in the caller (the frame's and the caller's
    releases).  ``sync_start_to_kernel_end`` is the host's wait."""
    by_id: dict = {}
    for s in prog:
        if s[3] is not None:
            by_id.setdefault(s[3], {})[s[0]] = s
    calls = sorted((s for s in bench_spans if s[0] == "submit"),
                   key=lambda s: s[1])
    starts = [c[1] for c in calls]
    acc: dict = {}
    for r, la, k in reqs:
        kids = by_id[r[3]]
        prep, sync = kids["engine.prepare"], kids["engine.sync"]
        call = calls[bisect.bisect_right(starts, r[1]) - 1]
        parts = {
            "call_to_entry": r[1] - call[1],
            "entry_to_prepare": prep[1] - r[1],
            "prepare": prep[2] - prep[1],
            "prepare_to_launch": la[1] - prep[2],
            "launch": la[2] - la[1],
            "launch_to_kernel_start": k[1] - la[2],
            "kernel": k[2] - k[1],
            "kernel_end_to_sync_return": sync[2] - k[2],
            "sync_return_to_root_end": r[2] - sync[2],
            "root_end_to_caller": call[2] - r[2],
            "sync_start_to_kernel_end": k[2] - sync[1],
        }
        for name, ns in parts.items():
            acc[name] = acc.get(name, 0) + ns
    return {name: ns / 1e3 / len(reqs) for name, ns in acc.items()}


def request_idle_us(w, ops) -> list:
    """Per request, the device's idle us from the benchmark's ``submit``
    span's start to its ``copy`` span's end."""
    from bench.devtrace import busy_ns, clip
    ops = sorted(ops, key=lambda o: o[1])
    starts = [o[1] for o in ops]
    calls = [s for s in w.spans if s[0] == "submit"]
    copies = [s for s in w.spans if s[0] == "copy"]
    out = []
    for c, y in zip(calls, copies):
        lo, hi = c[1], y[2]
        near = ops[max(0, bisect.bisect_left(starts, lo) - 1):
                   bisect.bisect_right(starts, hi)]
        out.append((hi - lo - busy_ns(clip(near, lo, hi))) / 1e3)
    return out


def cost(cell, engine, traffic, device, pairs, seconds) -> dict:
    """Tracing off against on, in (off, on, on, off) order: engine
    overhead (its mean, and the median over requests of the idle from
    ``submit`` to the copy's end) under the device trace, then steps per
    second without it."""
    from bench.harness import metric_reader
    overhead = {False: [], True: []}
    idle_median = {False: [], True: []}
    rate = {False: [], True: []}
    per_req = []
    for traced in (True, False):
        for _ in range(pairs):
            for observed in (False, True, True, False):
                w, tracer, _prog = window(engine, traffic, seconds, device,
                                          traced=traced, observed=observed)
                if traced:
                    view = _view(cell, w, tracer)
                    overhead[observed].append(metric_reader(
                        "engine_overhead_us")(view))
                    idle_median[observed].append(statistics.median(
                        request_idle_us(w, view.device_ops())))
                else:
                    rate[observed].append(w.answered_steps / w.seconds)
                    per_req.append(w.answered_steps / len(w.done))
    steps = statistics.fmean(per_req)
    mean = statistics.fmean
    return {
        "engine_overhead_us": {"off": overhead[False], "on": overhead[True]},
        "request_idle_median_us": {"off": idle_median[False],
                                   "on": idle_median[True]},
        "steps_per_s": {"off": rate[False], "on": rate[True]},
        "overhead_cost_us": mean(overhead[True]) - mean(overhead[False]),
        "idle_median_cost_us": (mean(idle_median[True])
                                - mean(idle_median[False])),
        "rate_cost_us": 1e6 * steps * (1 / mean(rate[True])
                                       - 1 / mean(rate[False])),
        "steps_per_request": steps,
    }


def host_ops(engine, traffic, device, reps: int) -> dict:
    """Median host us of pieces of the request path, each timed alone on
    an idle device, ``reps`` times: the inputs' pageable copy (``_prepare``'s
    ``as_tensor``, allocation and release included) and the same from
    pinned memory, x0's ``zeros``, the launch's operand checks, its grid
    lookup and its five allocations, a view by index, a synchronisation
    with nothing to wait for, one tracing-off site, and a one-step
    ``submit`` with tracing off and on in turns (its cost when on)."""
    import time

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
        check_operands, rollout_grid, stage_stride)
    op, dim = engine._fused, engine.config.reservoir_dim
    u_np = traffic.inputs(0)
    u_pin = torch.as_tensor(np.ascontiguousarray(u_np)).pin_memory()
    u = torch.as_tensor(u_np, device=device)[None]
    useq, x0 = u.transpose(0, 1), torch.zeros((1, dim), device=device)
    t, b, _ = useq.shape
    tile = op._batch_tile(1)
    grid, _ops = rollout_grid(op.tables, device)

    def allocs():
        return (torch.empty((t, b, op.out_dim), device=device),
                torch.empty((t, grid.n_blocks, b, op.out_dim),
                            device=device),
                torch.empty((b, dim), device=device),
                torch.empty(2 * b * stage_stride(op.tables),
                            dtype=torch.uint8, device=device),
                torch.empty((b, op.tables.rows_pad), device=device))

    steps = {
        "h2d_pageable": lambda: torch.as_tensor(
            u_np, dtype=torch.float32, device=device),
        "h2d_pinned": lambda: u_pin.to(device),
        "zeros_x0": lambda: torch.zeros((1, dim), device=device),
        "check_operands": lambda: check_operands(
            useq, op.tables, op.w_in, x0, op.w_out, None, tile, True,
            op.readout_every),
        "rollout_grid": lambda: rollout_grid(op.tables, device),
        "five_allocations": allocs,
        "index_view": lambda: u[0],
        "sync_idle": lambda: torch.cuda.synchronize(device),
        "obs_site_off": obs.tracer,
    }
    from repro_torch.serve import SubmitSpec
    one = SubmitSpec(u_np[:1])
    engine.submit(one)
    out = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize(device)
        ts = []
        for _ in range(reps):
            a = time.perf_counter_ns()
            fn()
            ts.append(time.perf_counter_ns() - a)
        out[name] = statistics.median(ts) / 1e3
    # tracing's own cost: one-step submits, off and on call by call
    calls = {False: [], True: []}
    for k in range(2 * reps):
        on = bool(k % 2)
        if on:
            obs.configure(metrics=False, events=False,
                          trace_capacity=SPLIT_CAPACITY)
        a = time.perf_counter_ns()
        engine.submit(one)
        calls[on].append(time.perf_counter_ns() - a)
        obs.disable()
    out["submit_1_step_off"] = statistics.median(calls[False]) / 1e3
    out["submit_1_step_on"] = statistics.median(calls[True]) / 1e3
    out["tracing_cost_pair_median"] = statistics.median(
        b - a for a, b in zip(calls[False], calls[True])) / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--pair-seconds", type=float, default=5.0)
    ap.add_argument("--reps", type=int, default=2000,
                    help="repetitions of each timed host operation")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    if not torch.cuda.is_available():
        print("probe_request_path: no CUDA device", file=sys.stderr)
        return 2
    from bench.gen import Traffic
    from bench.harness import build_program, load_cell, warm_up
    from bench.weights import make_weights
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload, ROOT)
    weights = make_weights(cell.cfg, args.seed, device)
    engine = build_program(cell.cfg, weights, args.seed, device)
    traffic = Traffic(cell.mix, args.seed, cell.cfg["input_dim"])
    warm_up(engine, traffic)
    torch.cuda.synchronize(device)

    w, tracer, prog = window(engine, traffic, args.seconds, device,
                             traced=True, observed=True)
    out = {"workload": args.workload, "seed": args.seed, "card": card(),
           "torch": torch.__version__, "window_s": w.seconds,
           "split": split(cell, w, tracer, prog)}
    if args.pairs:
        out["cost"] = cost(cell, engine, traffic, device, args.pairs,
                           args.pair_seconds)
    if args.reps:
        out["host_ops_us"] = host_ops(engine, traffic, device, args.reps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
