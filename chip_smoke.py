#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. builds the four CUDA sources from ``src/repro_torch`` at once (one
   nvcc each, into ``build/``) and prints each build time and ptxas line,
   the PyTorch/CUDA versions and the card's name and power limit;
2. holds both rollout kernels (B1 generic, B2 specialized; each call one
   persistent cooperative launch of all T steps, the readout inside it)
   against their plain PyTorch twins on the card, on dim-256 / block-64
   matrices (one with whole zero blocks) and a sparse block-32 one with
   shift-add digits, over {fp32, int8} x {resident, pipelined} x batch
   {3, 16}, with readout and final state;
3. drives the main serving path at ``LARGE_1024`` (dim 1024, int8-CSD):
   ``init_esn`` -> ``fit_readout`` -> an ``AsyncReservoirServer`` with 16
   slots answering a burst of 24 requests in 32-step chunks (five bursts,
   each on a fresh server), the same requests one-shot through
   ``submit_many`` (chunked must equal one-shot bit for bit), and through
   the generic kernel (``specialize=False``, must equal the specialized
   one bit for bit); a served chunk must be one B2 launch with the
   readout fused into it (no standalone readout launch);
4. serves fp32 requests at ``PAPER_BASELINE`` (dim 800) with both kernels,
   then holds both against their twins at that shape (a ragged last
   column block);
6. drives the fixed-matrix multiplier path at full width on LARGE_1024's
   matrix: ``BitplaneGemv`` (B3) on the requantized int8 states of a
   rollout at batch 16 and 1 (== ``matvec_int_exact`` and the twin, bit
   for bit), ``BcsrMatmul`` (B4) on fp32 and bf16 states and on integer
   states over a unit-scale matrix (exact), ``FusedReservoir.run`` (B5)
   over 64 steps at batch 16 (vs its twin and the fp32 B1 rollout), the
   cross-family check of tests/test_plan.py at dim 256, and all three at
   PAPER_BASELINE's ragged dim 800;
5. times each kernel per launch at the LARGE_1024 shape with CUDA events
   and the profiler, beside its plain twin, one PyTorch call computing the
   same product (and cuSPARSE for B4), and the least time the card could
   take (its bound); B1 and B2 per launch of T = 32 and 64 steps (reported
   per step), with each grid's shared memory per block, its host enqueue
   and a sweep of block counts; the standalone readout kernel against its
   twin; B3-B5 at batch 16 and 1.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Tolerances.  int8 states are exact (integer recurrent products, the same
# rounding sequence in kernel and twin); fp32 tile sums run in another
# order (kernel: per-thread FMA chain; twin: a library matmul), and a
# readout is a 1024-term float sum in another order in both modes.
FP32_TOL = 1e-4
READOUT_TOL = 1e-4

# phase 3 serves its 24-request burst this many times (fresh server each)
BURSTS = 5

# Published H100 SXM peaks (NVIDIA data sheet) used for the bounds.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12

_ROLLOUT_CU = "src/repro_torch/kernels/reservoir_rollout/csrc/rollout.cu"
# name -> (the Pallas kernel it replaces, its CUDA source)
KERNELS = {
    "specialized_rollout": (
        "src/repro/kernels/reservoir_rollout/specialized.py:162", _ROLLOUT_CU),
    "reservoir_rollout": (
        "src/repro/kernels/reservoir_rollout/reservoir_rollout.py:117",
        _ROLLOUT_CU),
    "rollout_readout": (
        "src/repro/kernels/reservoir_rollout/specialized.py:142", _ROLLOUT_CU),
    "bitplane_gemv": (
        "src/repro/kernels/bitplane_gemv/bitplane_gemv.py:55",
        "src/repro_torch/kernels/bitplane_gemv/csrc/bitplane_gemv.cu"),
    "bcsr_matmul": (
        "src/repro/kernels/bcsr_matmul/bcsr_matmul.py:43",
        "src/repro_torch/kernels/bcsr_matmul/csrc/bcsr_matmul.cu"),
    "reservoir_step": (
        "src/repro/kernels/reservoir_step/reservoir_step.py:44",
        "src/repro_torch/kernels/reservoir_step/csrc/reservoir_step.cu"),
}


def gpu_name_power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def maxdiff(a, b) -> float:
    if a.dtype.is_floating_point or b.dtype.is_floating_point:
        return float((a.float() - b.float()).abs().max().item())
    return float((a.long() - b.long()).abs().max().item())   # ints exact


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        # max |kernel - twin| per kernel and mode; None until a check ran
        self.err = {k: {"int8": None, "fp32": None} for k in KERNELS}
        self.failures: list[str] = []
        self.kernels: dict = {}
        self.card = ""

    def check(self, cond: bool, what: str) -> None:
        if not cond:
            self.failures.append(what)
            print(f"FAIL: {what}")

    def note_err(self, kernel, mode, value) -> None:
        old = self.err[kernel].get(mode)      # bf16: bcsr_matmul only
        self.err[kernel][mode] = value if old is None else max(old, value)

    # -- phase 1 -------------------------------------------------------------
    def build(self):
        """Builds every kernel source at once (one nvcc each, in threads)."""
        torch = self.torch
        from repro_torch.kernels.bcsr_matmul import bcsr_matmul
        from repro_torch.kernels.bitplane_gemv import bitplane_gemv
        from repro_torch.kernels.reservoir_rollout import _cuda
        from repro_torch.kernels.reservoir_step import reservoir_step
        libs = {"rollout.cu": _cuda.LIBRARY,
                "bitplane_gemv.cu": bitplane_gemv.LIBRARY,
                "bcsr_matmul.cu": bcsr_matmul.LIBRARY,
                "reservoir_step.cu": reservoir_step.LIBRARY}
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(lambda lib: lib.load(), libs.values()))
        self.card = gpu_name_power()
        print(f"build: {time.perf_counter() - t0:.2f} s for {len(libs)} "
              "sources in parallel")
        for name, lib in libs.items():
            info = lib.build_info()
            print(f"  {name}: {info['seconds']:.2f} s ({info['path']})")
            for line in info["log"].splitlines():
                if "registers" in line or "Compiling entry" in line:
                    print("    ptxas:", line.strip())
        print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
              f"python {sys.version.split()[0]}")
        print(f"card: {self.card}")

    # -- phase 2 -------------------------------------------------------------
    def _matrix(self, kind: str):
        """dim-256 test matrices: block-dense (block 64), the same with
        whole zero blocks, and a sparse one (block 32, 97% zeros) whose
        low-population digit planes become shift-add terms."""
        from repro_torch.core.sparse import FixedMatrix, random_sparse_matrix
        rng = np.random.default_rng(0)
        es, block = (0.97, 32) if kind == "sparse" else (0.9, 64)
        w = random_sparse_matrix(256, 256, es, rng) * 0.05
        if kind == "zero-blocks":
            w[:, 64:128] = 0.0          # a whole output column block
            w[0:64, 192:256] = 0.0      # single culled blocks
            w[128:192, 0:64] = 0.0
        return FixedMatrix.compile(w, weight_bits=8, mode="csd", block=block,
                                   rng=rng)

    def _pipelined_budget(self, plan, kmode):
        from repro_torch.plan import specialize_summary
        tile = plan.block * plan.block * (4 if kmode == "fp32" else 1)
        for n in range(1, 256):
            try:
                s = specialize_summary(plan, kmode, vmem_budget=2 * n * tile,
                                       batch_tile_max=16)
            except ValueError:
                continue
            if s["regime"] == "pipelined":
                return 2 * n * tile
        raise RuntimeError("no pipelined budget found")

    def twins(self):
        torch = self.torch
        from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
        from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
            reservoir_rollout_plain)
        from repro_torch.kernels.reservoir_rollout.specialized import (
            SpecializedRollout, specialized_rollout_plain)
        from repro_torch.plan import plan_for
        cases = 0
        for kind in ("dense-blocks", "zero-blocks", "sparse"):
            plan = plan_for(self._matrix(kind))
            print(f"matrix {kind}: block {plan.block}, "
                  f"{plan.blocks_nnz}/{plan.blocks_total} blocks kept")
            rng = np.random.default_rng(7)
            w_in = rng.uniform(-0.5, 0.5, (4, 256)).astype(np.float32)
            w_out = rng.uniform(-0.1, 0.1, (256, 4)).astype(np.float32)
            for kmode in ("fp32", "int8"):
                for regime in ("resident", "pipelined"):
                    budget = (None if regime == "resident"
                              else self._pipelined_budget(plan, kmode))
                    b1 = FusedRollout(plan, w_in, leak=0.7, mode=kmode,
                                      w_out=w_out, device=self.dev)
                    b2 = SpecializedRollout(
                        plan, w_in, leak=0.7, mode=kmode, w_out=w_out,
                        vmem_budget=budget, device=self.dev)
                    self.check(b2.regime == regime,
                               f"{kmode} regime {b2.regime} != {regime}")
                    for batch in (3, 16):
                        self._twin_case(
                            torch, b1, b2, reservoir_rollout_plain,
                            specialized_rollout_plain, kmode, batch,
                            f"{kind}/{kmode}/{regime}/b{batch}"
                            f" sa_digits={b2.tables.n_digits}")
                        cases += 1
        print(f"twin cases: {cases}")

    def _twin_case(self, torch, b1, b2, plain1, plain2, kmode, batch, tag):
        gen = torch.Generator(device="cpu").manual_seed(batch)
        t = 8
        u = torch.randn((t, batch, 4), generator=gen).to(self.dev)
        x0 = (0.5 * torch.randn((batch, 256), generator=gen)).to(self.dev)
        kw = dict(want_states=True, want_preds=True, want_final=True)
        got = {}
        for name, op, plain in (("reservoir_rollout", b1, plain1),
                                ("specialized_rollout", b2, plain2)):
            s, p, f = op(u, x0, **kw)
            common = dict(leak=op.leak, smax=op.smax,
                          recur_scale=op.recur_scale, readout_every=1, **kw)
            ps, pp, pf = plain(u, op.tables, op.w_in, x0, op.w_out, **common)
            torch.cuda.synchronize()
            ds, df = maxdiff(s, ps), maxdiff(f, pf)
            dp = maxdiff(p, pp)
            self.note_err(name, kmode, max(ds, df))
            self.note_err("rollout_readout", kmode, dp)
            tol = 0.0 if kmode == "int8" else FP32_TOL
            self.check(ds <= tol and df <= tol,
                       f"{name} vs twin {tag}: states {ds:.3g} final {df:.3g}")
            self.check(dp <= READOUT_TOL, f"{name} preds vs twin {tag}: "
                       f"{dp:.3g}")
            got[name] = (s, p, f)
        same = all(torch.equal(a, b) for a, b in zip(
            got["reservoir_rollout"], got["specialized_rollout"]))
        if kmode == "int8":
            self.check(same, f"B2 != B1 bit for bit {tag}")
        # chunked with the carry donated in place == one-shot
        carry = x0.clone()
        s1, _ = b2(u[:4], carry, want_states=True, want_final=True,
                   donate_state=True)
        s2, f2 = b2(u[4:], carry, want_states=True, want_final=True,
                    donate_state=True)
        self.check(torch.equal(torch.cat([s1, s2]), got["specialized_rollout"][0])
                   and torch.equal(f2, got["specialized_rollout"][2])
                   and f2.data_ptr() == carry.data_ptr(),
                   f"donated chunked != one-shot {tag}")
        print(f"  {tag}: B1/B2 vs twins ok, B1==B2 {same}")

    # -- phase 3 -------------------------------------------------------------
    def main_path(self):
        torch = self.torch
        from repro_torch.configs.esn_paper import LARGE_1024, PAPER_BASELINE
        from repro_torch.core.esn import (fit_readout, init_esn, nrmse,
                                          run_readout, run_reservoir)
        from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
            reservoir_rollout, rollout_readout)
        from repro_torch.kernels.reservoir_rollout.specialized import (
            specialized_rollout)
        from repro_torch.serve import (AsyncReservoirServer, ReservoirEngine,
                                       ServeStats, SubmitSpec)
        counted = {"specialized_rollout": specialized_rollout,
                   "reservoir_rollout": reservoir_rollout}
        for fn in counted.values():
            fn.launches = 0
        rollout_readout.launches = rollout_readout.fused_launches = 0

        t0 = time.perf_counter()
        params = init_esn(LARGE_1024, device=self.dev)
        print(f"init_esn LARGE_1024: {time.perf_counter() - t0:.2f} s, "
              f"{params.w.plan().blocks_nnz}/{params.w.plan().blocks_total} "
              f"blocks kept, w.scale {params.w.scale!r}")
        steps = np.arange(1200, dtype=np.float32)
        signal = (np.sin(0.2 * steps) * np.cos(0.031 * steps)
                  ).astype(np.float32)[:, None]
        u_train = torch.as_tensor(signal[:-1], device=self.dev)
        y_train = torch.as_tensor(signal[1:], device=self.dev)
        states = run_reservoir(params, u_train)
        params = fit_readout(params, states, y_train, lam=1e-4, washout=100)
        pred = run_readout(params, u_train)
        err = float(nrmse(pred[100:], y_train[100:]).item())
        print(f"fit_readout: one-step-ahead NRMSE {err:.4g} "
              "(teacher signal, after 100-step washout)")
        self.check(np.isfinite(err) and err < 0.5, f"NRMSE {err}")
        self.params_1024 = params

        eng = ReservoirEngine(params)
        print("program:", eng.program.describe())
        rng = np.random.default_rng(11)
        lengths = rng.integers(64, 257, size=24)
        specs = [SubmitSpec(
            signal[s:s + n] + 0.01 * rng.standard_normal((n, 1)).astype(
                np.float32), uid=i)
            for i, (n, s) in enumerate(zip(lengths, rng.integers(0, 900, 24)))]
        # the same burst BURSTS times, each on a fresh server: the rate is
        # all requests over all wall time, beside each burst's own rate
        bursts, served = [], []
        n_req = BURSTS * len(specs)
        b2_served = fused_served = chunks = 0
        for _ in range(BURSTS):
            # stats of its own: the engine's would add up across bursts;
            # the server's warm-up launch at construction is not served
            srv = AsyncReservoirServer(eng, n_slots=16, chunk_steps=32,
                                       stats=ServeStats())
            before = (specialized_rollout.launches,
                      rollout_readout.fused_launches)
            for i, spec in enumerate(specs):
                srv.submit(spec, arrival_time=0.001 * i)
            t0 = time.perf_counter()
            res = srv.run()
            torch.cuda.synchronize()
            bursts.append(time.perf_counter() - t0)
            chunks += srv.stats.chunks
            b2_served += specialized_rollout.launches - before[0]
            fused_served += rollout_readout.fused_launches - before[1]
            served.append(res)
            self.check(len(res) == len(specs) and all(
                r.status == "ok" and r.preds.shape == (n, 1)
                and np.isfinite(r.preds).all()
                for r, n in zip((res[i] for i in range(len(specs))),
                                lengths)),
                "server answered every request")
        self.chunk_launches = b2_served / max(chunks, 1)
        self.check(b2_served > 0, "B2 launched by the server")
        self.check(b2_served == chunks and fused_served == chunks
                   and rollout_readout.launches == 0,
                   f"one B2 launch with its readout fused per served chunk "
                   f"({b2_served} launches, {fused_served} fused readouts, "
                   f"{rollout_readout.launches} readout launches, "
                   f"{chunks} chunks)")
        wall = sum(bursts)
        print(f"server: {BURSTS} bursts x {len(specs)} requests, "
              f"{BURSTS * int(lengths.sum())} steps, {chunks} chunks, "
              f"{wall:.4f} s wall = {n_req / wall:.1f} requests/s, "
              f"{BURSTS * lengths.sum() / wall:.0f} steps/s "
              f"({b2_served} B2 launches, {self.chunk_launches:g} per "
              f"chunk; {fused_served} fused readouts, "
              f"{rollout_readout.launches} standalone readout launches) "
              f"on {self.card}")
        print("  per burst requests/s: "
              + ", ".join(f"{len(specs) / w:.1f}" for w in bursts))
        # the same burst with every request there at time 0: the arrivals
        # above are 1 ms apart on the server's clock, which bounds a burst
        # below by 23 ms; here the pool stays full and the chunk cost sets
        # the rate
        walls, chunks0 = [], 0
        for _ in range(BURSTS):
            srv = AsyncReservoirServer(eng, n_slots=16, chunk_steps=32,
                                       stats=ServeStats())
            for spec in specs:
                srv.submit(spec, arrival_time=0.0)
            t0 = time.perf_counter()
            srv.run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            chunks0 += srv.stats.chunks
        print(f"server, all arrivals at 0: {n_req / sum(walls):.1f} "
              f"requests/s, {chunks0} chunks, "
              f"{sum(walls) / chunks0 * 1e6:.1f} us per chunk (per burst "
              + ", ".join(f"{len(specs) / w:.1f}" for w in walls)
              + f") on {self.card}")

        one_walls = []
        for _ in range(BURSTS):
            t0 = time.perf_counter()
            one = eng.submit_many(specs)
            torch.cuda.synchronize()
            one_walls.append(time.perf_counter() - t0)
        print(f"one-shot submit_many: {BURSTS} x {len(specs)} requests, "
              f"{sum(one_walls):.4f} s wall = "
              f"{n_req / sum(one_walls):.1f} requests/s (per call: "
              + ", ".join(f"{len(specs) / w:.1f}" for w in one_walls)
              + f") on {self.card}")
        exact = all(np.array_equal(res[i].preds, one[i].preds.cpu().numpy())
                    for res in served for i in range(len(specs)))
        self.check(exact, "chunked == one-shot bit for bit (LARGE_1024)")
        generic = ReservoirEngine(params, specialize=False).submit_many(specs)
        same = all(torch.equal(generic[i].preds, one[i].preds)
                   for i in range(len(specs)))
        self.check(same, "B1 == B2 bit for bit (LARGE_1024 one-shot)")
        print(f"chunked == one-shot: {exact}; B1 == B2: {same}")
        self.requests_per_s = n_req / wall

        # -- phase 4: fp32 at PAPER_BASELINE -------------------------------
        p800 = init_esn(PAPER_BASELINE, device=self.dev)
        gen = torch.Generator(device="cpu").manual_seed(3)
        p800 = dataclasses.replace(p800, w_out=(0.05 * torch.randn(
            (800, 1), generator=gen)).to(self.dev))
        specs800 = [SubmitSpec(signal[: n], uid=i)
                    for i, n in enumerate((40, 64, 100, 77))]
        a = ReservoirEngine(p800).submit_many(specs800)
        b = ReservoirEngine(p800, specialize=False).submit_many(specs800)
        d = max(maxdiff(a[i].preds, b[i].preds) for i in a)
        self.check(d <= FP32_TOL, f"PAPER_BASELINE fp32 B2 vs B1 {d:.3g}")
        print(f"PAPER_BASELINE fp32 (dim 800 -> 7 column blocks of 128): "
              f"specialized vs generic max |diff| {d:.3g}")
        self.launches = {k: fn.launches for k, fn in counted.items()}
        # the readout runs inside the rollout launches on this path
        self.launches["rollout_readout"] = rollout_readout.fused_launches
        self.check(rollout_readout.launches == 0,
                   "no standalone readout launch on the main path")
        print("main-path launches (rollout_readout: fused readouts):",
              self.launches)
        for k, n in self.launches.items():
            self.check(n > 0, f"{k} launched on the main path")
        self.params_800 = p800

    def baseline_twins(self):
        """B1 and B2 against their twins at phase 4's fp32 shape: dim 800
        in 7 column blocks of 128, the last one ragged (96 columns)."""
        torch = self.torch
        from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
        from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
            reservoir_rollout_plain)
        from repro_torch.kernels.reservoir_rollout.specialized import (
            SpecializedRollout, specialized_rollout_plain)
        params = self.params_800
        cfg = params.config
        gen = torch.Generator(device="cpu").manual_seed(13)
        u = torch.randn((32, 4, cfg.input_dim), generator=gen).to(self.dev)
        x0 = (0.5 * torch.randn((4, cfg.reservoir_dim),
                                generator=gen)).to(self.dev)
        kw = dict(want_states=True, want_preds=True, want_final=True)
        for name, cls, plain in (
                ("specialized_rollout", SpecializedRollout,
                 specialized_rollout_plain),
                ("reservoir_rollout", FusedRollout, reservoir_rollout_plain)):
            op = cls(params.w.plan(), params.w_in, leak=cfg.leak, mode="fp32",
                     w_out=params.w_out, device=self.dev)
            s, p, f = op(u, x0, **kw)
            ps, pp, pf = plain(u, op.tables, op.w_in, x0, op.w_out,
                               leak=op.leak, smax=op.smax,
                               recur_scale=op.recur_scale, readout_every=1,
                               **kw)
            torch.cuda.synchronize()
            ds, dp = max(maxdiff(s, ps), maxdiff(f, pf)), maxdiff(p, pp)
            self.note_err(name, "fp32", ds)
            self.note_err("rollout_readout", "fp32", dp)
            self.check(ds <= FP32_TOL and dp <= READOUT_TOL,
                       f"{name} vs twin at PAPER_BASELINE: states {ds:.3g} "
                       f"preds {dp:.3g}")
            print(f"  PAPER_BASELINE fp32 {name} vs twin: states {ds:.3g}, "
                  f"preds {dp:.3g}")

    # -- phase 5 -------------------------------------------------------------
    def times(self):
        """B1 and B2 at the LARGE_1024 serve shape (B = 16, int8): one
        launch of T = 32 (a served chunk) and of T = 64 steps, reported
        per step, by CUDA events and the profiler, with the host enqueue
        per launch and a sweep of block counts; then the standalone
        readout kernel."""
        torch = self.torch
        from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
        from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
            _launch_rollout, reservoir_rollout, reservoir_rollout_plain,
            rollout_grid, rollout_readout)
        from repro_torch.kernels.reservoir_rollout.specialized import (
            SpecializedRollout, specialized_rollout, specialized_rollout_plain)
        params = self.params_1024
        cfg = params.config
        plan = params.w.plan()
        b, reps = 16, 20
        gen = torch.Generator(device="cpu").manual_seed(5)
        u = torch.randn((64, b, 1), generator=gen).to(self.dev)
        x0 = (0.5 * torch.randn((b, cfg.reservoir_dim),
                                generator=gen)).to(self.dev)
        ops = {
            "specialized_rollout": (SpecializedRollout(
                plan, params.w_in, leak=cfg.leak, mode="int8",
                w_out=params.w_out, device=self.dev),
                specialized_rollout_plain, specialized_rollout),
            "reservoir_rollout": (FusedRollout(
                plan, params.w_in, leak=cfg.leak, mode="int8",
                w_out=params.w_out, device=self.dev), reservoir_rollout_plain,
                reservoir_rollout),
        }

        timed = self.timed
        dense = params.w.dense_f32(device=self.dev)
        x = x0.clone()
        lib_step = timed(lambda: x @ dense, 200)
        bk = plan.block
        kw = dict(want_states=True, want_preds=False, want_final=False)
        extras = {}          # per kernel: its grid and its time sweeps
        for name, (op, _plain, _fn) in ops.items():
            grid, _ = rollout_grid(op.tables, self.dev)
            print(f"  {name} grid: {grid.n_blocks} blocks of {grid.cw} "
                  f"columns, share {grid.share_bytes} B per block, "
                  f"{'resident' if grid.resident else 'streamed'}, "
                  f"{grid.smem} B shared memory per block")
            extras[name] = dict(
                n_blocks=grid.n_blocks, share_bytes=grid.share_bytes,
                resident=grid.resident, smem_bytes=grid.smem)
        # in turns (B2, B1, B1, B2): the minimum of each kernel's two runs,
        # per step, for one launch of T steps
        runs = {(name, t): [] for name in ops for t in (32, 64)}
        for name in ("specialized_rollout", "reservoir_rollout",
                     "reservoir_rollout", "specialized_rollout"):
            op = ops[name][0]
            for t in (32, 64):
                runs[name, t].append(
                    timed(lambda: op(u[:t], x0, **kw), reps) / t)
        print("per-step runs (ms):",
              {f"{k[0]} T={k[1]}": v for k, v in runs.items()})
        for name, (op, _p, _f) in ops.items():
            for t in (32, 64):
                dev_us = self._device_us(lambda: op(u[:t], x0, **kw),
                                         "rollout_kernel")
                extras[name][f"device_us_per_launch_T{t}"] = \
                    dev_us
                print(f"  {name} T={t}: {dev_us:.2f} us device time per "
                      f"launch = {dev_us / t:.3f} us/step on {self.card}")
        for name, (op, plain, fn) in ops.items():
            extra = extras[name]
            for t in (32, 64):
                extra[f"ms_per_step_T{t}"] = min(runs[name, t])
                extra[f"ms_per_launch_T{t}"] = min(runs[name, t]) * t
                host = self._host_ms(lambda: op(u[:t], x0, **kw), reps)
                extra[f"host_ms_per_launch_T{t}"] = host
                print(f"  {name} T={t}: {min(runs[name, t]) * 1e3:.3f} us/step"
                      f", {min(runs[name, t]) * t * 1e3:.2f} us/launch, host "
                      f"enqueue {host * 1e3:.1f} us/launch on {self.card}")
            # block-count sweep, one launch of T = 64 steps
            sweep = {}
            chosen = extra["n_blocks"]
            for nb in sorted({32, 64, 128, chosen}):
                grid, _ = rollout_grid(op.tables, self.dev, nb)
                call = lambda nb=nb: _launch_rollout(   # noqa: E731
                    fn, u, op.tables, op.w_in, x0, None, leak=op.leak,
                    smax=op.smax, recur_scale=op.recur_scale, b_tile=b,
                    n_blocks=nb, **kw)
                sweep[nb] = timed(call, reps) / 64
                print(f"  {name} {nb} blocks ({grid.cw} columns, "
                      f"{'resident' if grid.resident else 'streamed'}, "
                      f"{grid.smem} B smem/block): {sweep[nb] * 1e3:.3f} "
                      f"us/step{' (chosen)' if nb == chosen else ''}")
            extra["ms_per_step_by_blocks"] = sweep
            # the same launch at batch 1: what of a step scales with B
            u1, x1 = u[:, :1], x0[:1]
            extra["ms_per_step_batch1"] = timed(
                lambda: op(u1, x1, **kw), reps) / 64
            print(f"  {name} batch 1, T=64: "
                  f"{extra['ms_per_step_batch1'] * 1e3:.3f} us/step on "
                  f"{self.card}")
        for name, (op, plain, _fn) in ops.items():
            per_step = min(runs[name, 64])
            common = dict(leak=op.leak, smax=op.smax,
                          recur_scale=op.recur_scale, readout_every=1, **kw)
            short = u[:8]
            plain_step = timed(lambda: plain(short, op.tables, op.w_in, x0,
                                             None, **common), 2) / 8
            # the served shape's states and its fused readout (per-block
            # partial sums reduced across the grid) against the twin
            got_s, got_p = op(u[:16], x0, want_states=True, want_preds=True)
            ref_s, ref_p = plain(u[:16], op.tables, op.w_in, x0, op.w_out,
                                 **dict(common, want_preds=True))
            d, dp = maxdiff(got_s, ref_s), maxdiff(got_p, ref_p)
            self.note_err(name, "int8", d)
            self.note_err("rollout_readout", "int8", dp)
            self.check(d == 0.0 and dp <= READOUT_TOL,
                       f"{name} vs twin at LARGE_1024: states {d:.3g}, "
                       f"fused readout {dp:.3g}")
            print(f"  LARGE_1024 int8 {name} vs twin, T=16: states {d:.3g}, "
                  f"fused readout {dp:.3g}")
            tb = op.tables
            n_mm = tb.n_matmul_terms
            bytes_ = (n_mm * bk * bk + tb.n_digits * 16
                      + len(tb.terms_host) * 16 + 2 * b * cfg.reservoir_dim * 4
                      + b * cfg.input_dim * 4
                      + cfg.input_dim * cfg.reservoir_dim * 4)
            int_ops = 2 * n_mm * bk * bk * b + 2 * tb.n_digits * b
            f32_ops = b * cfg.reservoir_dim * (2 * cfg.input_dim + 6)
            self._record(name, per_step, plain_step, lib_step, bytes_,
                         int_ops / INT8_OPS_PER_S + f32_ops / FP32_FLOPS_PER_S)
            self.kernels[name].update(extras[name])
        o = params.w_out.shape[1]
        out = torch.empty((b, o), device=self.dev)
        ro = timed(lambda: rollout_readout(x0, params.w_out, out), 200)
        ro_plain = timed(lambda: x0 @ params.w_out, 200)
        d = maxdiff(rollout_readout(x0, params.w_out), x0 @ params.w_out)
        self.note_err("rollout_readout", "fp32", d)
        self.check(d <= READOUT_TOL, f"readout vs twin at LARGE_1024 {d:.3g}")
        dim = cfg.reservoir_dim
        self._record("rollout_readout", ro, ro_plain, ro_plain,
                     (b * dim + dim * o + b * o) * 4,
                     2 * b * dim * o / FP32_FLOPS_PER_S)
        self.kernels["rollout_readout"]["device_us_per_launch"] = \
            self._device_us(lambda: rollout_readout(x0, params.w_out, out),
                            "readout_kernel")

    # -- phase 6 -------------------------------------------------------------
    def _unit_scale(self, dim, block):
        """tests/test_plan.py's integer matrix: amax == qmax, so scale is
        1.0 and float and integer products meet on exact integers."""
        from repro_torch.core.sparse import FixedMatrix
        rng = np.random.default_rng(0)
        q = rng.integers(-127, 128, size=(dim, dim)).astype(np.float64)
        q[rng.random((dim, dim)) < 0.9] = 0
        q[dim // 2:, :] = 0
        q[0, 0] = 127
        return FixedMatrix.compile(q, weight_bits=8, mode="csd", block=block,
                                   rng=rng)

    def _states(self, params, batch, steps, seed):
        """Final fp32 states of an int8 B2 rollout, and their int8
        requantization (what the int8 path multiplies)."""
        torch = self.torch
        from repro_torch.kernels.reservoir_rollout.specialized import (
            SpecializedRollout)
        cfg = params.config
        op = SpecializedRollout(params.w.plan(), params.w_in, leak=cfg.leak,
                                mode="int8", device=self.dev)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        u = torch.randn((steps, batch, cfg.input_dim), generator=gen)
        x = op(u.to(self.dev), want_states=False, want_final=True)
        xq = torch.clamp(torch.round(x * op.smax), -op.smax - 1, op.smax)
        return x, xq.to(torch.int8)

    def _check_b3(self, op, fm, xq, tag):
        from repro_torch.kernels.bitplane_gemv.bitplane_gemv import (
            bitplane_gemv_plain)
        y = op(xq)
        twin = bitplane_gemv_plain(xq, op.digits, op.plane_mask)
        d = max(maxdiff(y, fm.matvec_int_exact(xq)),
                maxdiff(y, twin[:, : op.cols]))
        self.note_err("bitplane_gemv", "int8", d)
        self.check(d == 0.0, f"bitplane_gemv {tag}: {d:.3g}")
        return y, d

    def _check_b4(self, op, x, tag, mode, exact=None):
        from repro_torch.kernels.bcsr_matmul.bcsr_matmul import (
            bcsr_matmul_plain)
        y = op(x)
        twin = bcsr_matmul_plain(x, op.tiles, op.col_ptr, op.tile_rows,
                                 op.rows_pad)[:, : op.shape[1]]
        d = maxdiff(y, twin)
        if exact is not None:
            d = max(d, maxdiff(y, exact))
        self.note_err("bcsr_matmul", mode, d)
        tol = 0.0 if mode == "int8" else FP32_TOL
        self.check(y.dtype == twin.dtype and d <= tol,
                   f"bcsr_matmul {tag}: {d:.3g}")
        return y, d

    def _check_b5(self, fr, u, tag, against=None):
        torch = self.torch
        from repro_torch.kernels.reservoir_step.reservoir_step import (
            reservoir_step_plain)
        states = fr.run(u)
        x = torch.zeros((u.shape[1], fr.dim), device=self.dev)
        twin = []
        for t in range(u.shape[0]):
            x = reservoir_step_plain(x, fr.w, u[t], fr.w_in, leak=fr.leak)
            twin.append(x)
        d = maxdiff(states, torch.stack(twin))
        self.note_err("reservoir_step", "fp32", d)
        self.check(d <= FP32_TOL, f"reservoir_step {tag} vs twin: {d:.3g}")
        if against is not None:
            da = maxdiff(states, against)
            self.check(da <= FP32_TOL, f"reservoir_step {tag} vs fp32 B1: "
                       f"{da:.3g}")
            return d, da
        return d, None

    def fixed_matrix(self):
        """Phase 6: the fixed-matrix multiplier path at full width
        (LARGE_1024's matrix, made in phase 3), through BitplaneGemv (B3),
        BcsrMatmul (B4) and FusedReservoir (B5), each checked against its
        twin and an exact or independent reference."""
        torch = self.torch
        from repro_torch.kernels.bcsr_matmul import bcsr_matmul as b4
        from repro_torch.kernels.bcsr_matmul.ops import BcsrMatmul
        from repro_torch.kernels.bitplane_gemv import bitplane_gemv as b3
        from repro_torch.kernels.bitplane_gemv.ops import BitplaneGemv
        from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
        from repro_torch.kernels.reservoir_step import reservoir_step as b5
        from repro_torch.kernels.reservoir_step.ops import FusedReservoir
        counted = {"bitplane_gemv": b3.bitplane_gemv,
                   "bcsr_matmul": b4.bcsr_matmul,
                   "reservoir_step": b5.reservoir_step}
        for fn in counted.values():
            fn.launches = 0

        params = self.params_1024
        cfg = params.config
        fm = params.w
        plan = fm.plan()
        x, xq = self._states(params, 16, 32, seed=17)
        self.fixed_inputs = (x, xq)
        b3op = BitplaneGemv(plan, device=self.dev)
        print(f"LARGE_1024 planes: {sum(plan.plane_mask)}/{plan.width} kept, "
              f"{b3op.digits.numel()} B of digits")
        for batch in (16, 1):
            _y, d = self._check_b3(b3op, fm, xq[:batch], f"LARGE_1024 b{batch}")
            print(f"  B3 BitplaneGemv int8 states b{batch}: "
                  f"== matvec_int_exact and twin (max |diff| {d:g})")

        b4op = BcsrMatmul(plan, device=self.dev)
        print(f"LARGE_1024 BCSR: {b4op.n_tiles} tiles of {b4op.block}")
        for batch in (16, 1):
            _y, d = self._check_b4(b4op, x[:batch], f"fp32 b{batch}", "fp32")
            print(f"  B4 BcsrMatmul fp32 b{batch} vs twin: {d:.3g}")
        _y, d = self._check_b4(b4op, x.to(torch.bfloat16), "bf16 b16", "bf16")
        print(f"  B4 BcsrMatmul bf16 b16 vs twin: {d:.3g}")
        unit = self._unit_scale(cfg.reservoir_dim, cfg.block)
        uop = BcsrMatmul(unit, device=self.dev)
        for dtype in (torch.int32, torch.int8):
            xi = xq.to(dtype)
            _y, d = self._check_b4(uop, xi, f"unit-scale {dtype}", "int8",
                                   exact=unit.matvec_int_dense_ref(xi))
            print(f"  B4 BcsrMatmul {dtype} on the unit-scale matrix: "
                  f"exact ({d:g})")

        dense = fm.dense_f32(device=self.dev)
        fr = FusedReservoir(dense, params.w_in, leak=cfg.leak,
                            device=self.dev)
        gen = torch.Generator(device="cpu").manual_seed(19)
        u = torch.randn((64, 16, cfg.input_dim), generator=gen).to(self.dev)
        b1 = FusedRollout(plan, params.w_in, leak=cfg.leak, mode="fp32",
                          device=self.dev)(u)
        d, da = self._check_b5(fr, u, "LARGE_1024 64 steps b16", against=b1)
        print(f"  B5 FusedReservoir.run 64 steps b16: vs twin {d:.3g}, vs "
              f"fp32 B1 rollout {da:.3g}")

        self._cross_family()
        self._ragged_fixed()
        self.launches.update({k: fn.launches for k, fn in counted.items()})
        print("phase-6 launches:", {k: self.launches[k] for k in counted})
        for k in counted:
            self.check(self.launches[k] > 0, f"{k} launched on phase 6")

    def _cross_family(self):
        """tests/test_plan.py's check on the card: one unit-scale plan, B3
        == xq @ q, B4 (fp32 input) == the same, one int8 B1 step ==
        tanh(y * recur_scale), all exact."""
        torch = self.torch
        from repro_torch.kernels.bcsr_matmul.ops import BcsrMatmul
        from repro_torch.kernels.bitplane_gemv.ops import BitplaneGemv
        from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
        fm = self._unit_scale(256, 64)
        plan = fm.plan()
        rng = np.random.default_rng(1)
        xq = torch.as_tensor(rng.integers(-4, 5, size=(3, 256)),
                             dtype=torch.int32, device=self.dev)
        exact = fm.matvec_int_dense_ref(xq)
        y_int, _ = self._check_b3(BitplaneGemv(plan, device=self.dev), fm, xq,
                                  "cross-family")
        y_f = BcsrMatmul(plan, device=self.dev)(xq.to(torch.float32))
        fr = FusedRollout(plan, np.zeros((1, 256), np.float32), leak=1.0,
                          mode="int8", device=self.dev)
        got = fr(torch.zeros((1, 3, 1), device=self.dev),
                 xq.to(torch.float32) / fr.smax)[0]
        want = torch.tanh(y_int.to(torch.float32) * torch.tensor(
            fr.recur_scale, dtype=torch.float32, device=self.dev))
        ok = (torch.equal(y_int, exact)
              and torch.equal(y_f, exact.to(torch.float32))
              and torch.equal(got, want))
        self.note_err("bcsr_matmul", "fp32", maxdiff(y_f, exact))
        self.check(ok, "cross-family B3 == B4 == xq @ q, B1 == tanh(y rs)")
        print(f"cross-family (unit scale, dim 256): exact {ok}")

    def _ragged_fixed(self):
        """PAPER_BASELINE (dim 800: 7 column blocks of 128, the last one
        96 wide) through all three wrappers."""
        from repro_torch.kernels.bcsr_matmul.ops import BcsrMatmul
        from repro_torch.kernels.bitplane_gemv.ops import BitplaneGemv
        from repro_torch.kernels.reservoir_step.ops import FusedReservoir
        params = self.params_800
        cfg = params.config
        plan = params.w.plan()
        x, xq = self._states(params, 5, 8, seed=23)
        _y, d3 = self._check_b3(BitplaneGemv(plan, device=self.dev), params.w,
                                xq, "PAPER_BASELINE")
        _y, d4 = self._check_b4(BcsrMatmul(plan, device=self.dev), x,
                                "PAPER_BASELINE fp32", "fp32")
        fr = FusedReservoir(params.w.dense_f32(device=self.dev), params.w_in,
                            leak=cfg.leak, device=self.dev)
        gen = self.torch.Generator(device="cpu").manual_seed(29)
        u = self.torch.randn((16, 5, cfg.input_dim), generator=gen)
        d5, _ = self._check_b5(fr, u.to(self.dev), "PAPER_BASELINE")
        print(f"PAPER_BASELINE (dim 800) B3 {d3:g}, B4 {d4:.3g}, B5 {d5:.3g} "
              "vs twins")

    # -- phase 5, the fixed-matrix kernels -----------------------------------
    def fixed_times(self):
        """B3, B4 and B5 per launch at the LARGE_1024 shape, batch 16 (the
        main entry) and batch 1 (the paper's latency case), beside their
        twins, one library call each and their bounds."""
        torch = self.torch
        from repro_torch.kernels.bcsr_matmul.bcsr_matmul import (
            bcsr_matmul_plain)
        from repro_torch.kernels.bcsr_matmul.ops import BcsrMatmul
        from repro_torch.kernels.bitplane_gemv.bitplane_gemv import (
            bitplane_gemv_plain)
        from repro_torch.kernels.bitplane_gemv.ops import BitplaneGemv
        from repro_torch.kernels.reservoir_step.ops import FusedReservoir
        from repro_torch.kernels.reservoir_step.reservoir_step import (
            reservoir_step_plain)
        timed = self.timed
        params = self.params_1024
        cfg = params.config
        plan = params.w.plan()
        r = c = cfg.reservoir_dim
        b3op = BitplaneGemv(plan, device=self.dev)
        b4op = BcsrMatmul(plan, device=self.dev)
        dense = params.w.dense_f32(device=self.dev)
        fr = FusedReservoir(dense, params.w_in, leak=cfg.leak,
                            device=self.dev)
        qf = torch.as_tensor(params.w.q, device=self.dev).to(torch.float32)
        csr_t = dense.t().contiguous().to_sparse_csr()     # cuSPARSE: M^T
        kept = sum(plan.plane_mask)
        x16, xq16 = self.fixed_inputs
        i_dim = cfg.input_dim
        gen = torch.Generator(device="cpu").manual_seed(31)
        u16 = torch.randn((16, i_dim), generator=gen).to(self.dev)
        f32 = FP32_FLOPS_PER_S
        for batch in (16, 1):
            x, xq, u = x16[:batch], xq16[:batch], u16[:batch]
            key = None if batch == 16 else batch
            b3_ms = timed(lambda: b3op(xq), 200)
            b3_plain = timed(lambda: bitplane_gemv_plain(
                xq, b3op.digits, b3op.plane_mask), 5)
            b3_lib = timed(lambda: xq.float() @ qf, 200)
            self._record("bitplane_gemv", b3_ms, b3_plain, b3_lib,
                         kept * r * c + batch * r + 4 * batch * c,
                         2 * kept * batch * r * c / INT8_OPS_PER_S, key)
            b4_ms = timed(lambda: b4op(x), 200)
            b4_plain = timed(lambda: bcsr_matmul_plain(
                x, b4op.tiles, b4op.col_ptr, b4op.tile_rows, b4op.rows_pad),
                5)
            b4_lib = timed(lambda: x @ dense, 200)
            xt = x.t().contiguous()
            b4_sparse = timed(lambda: torch.sparse.mm(csr_t, xt), 200)
            tile_elems = b4op.n_tiles * b4op.block ** 2
            print(f"cuSPARSE torch.sparse.mm (CSR, {csr_t.values().numel()} "
                  f"nonzeros) b{batch}: {b4_sparse * 1e3:.2f} us on "
                  f"{self.card}")
            self._record("bcsr_matmul", b4_ms, b4_plain, b4_lib,
                         4 * (tile_elems + batch * r + batch * c),
                         2 * batch * tile_elems / f32, key)
            self.kernels["bcsr_matmul"][
                "cusparse_ms" if key is None else f"cusparse_ms_batch{batch}"
            ] = b4_sparse
            out = torch.empty((batch, r), device=self.dev)
            b5_ms = timed(lambda: fr.step(x, u, out=out), 200)
            b5_plain = timed(lambda: reservoir_step_plain(
                x, fr.w, u, fr.w_in, leak=fr.leak), 50)
            b5_lib = timed(lambda: x @ dense, 200)
            self._record("reservoir_step", b5_ms, b5_plain, b5_lib,
                         4 * (r * r + i_dim * r + batch * i_dim
                              + 2 * batch * r),
                         batch * r * (2 * r + 2 * i_dim + 6) / f32, key)
            calls = {"bitplane_gemv": lambda: b3op(xq),
                     "bcsr_matmul": lambda: b4op(x),
                     "reservoir_step": lambda: fr.step(x, u, out=out)}
            for name, call in calls.items():
                rec = self.kernels[name] if key is None else \
                    self.kernels[name][f"batch{batch}"]
                rec["host_ms"] = self._host_ms(call, 50)
                print(f"  {name} b{batch}: host enqueue "
                      f"{rec['host_ms'] * 1e3:.1f} us/launch")
            self._profile([*calls.values(), lambda: xq.float() @ qf,
                           lambda: x @ dense,
                           lambda: torch.sparse.mm(csr_t, xt)])

    def _host_ms(self, fn, n):
        """ms per call of ``fn`` on the host clock with no device sync
        inside the loop: the Python wrapper's issue cost."""
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = (time.perf_counter() - t0) / n * 1e3
        self.torch.cuda.synchronize()
        return host

    def timed(self, fn, n):
        """ms per call of ``fn`` over ``n`` calls, by CUDA events, after
        one warm-up call."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def _profile(self, calls):
        """Device time per kernel launch from a torch.profiler trace (the
        CUDA-event times include any gaps between launches)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            for call in calls:
                call()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.count and e.device_time_total > 0]
        if not rows:
            print("profiler: no device kernels recorded")
        for e in rows:
            print(f"  profiler {e.key[:60]}: {e.count} launches, "
                  f"{e.device_time_total / e.count:.2f} us device time each")
        return rows

    def _device_us(self, call, kernel: str):
        """Device µs of one call's launches of ``kernel`` (profiler)."""
        rows = self._profile([call])
        return sum(e.device_time_total for e in rows if kernel in e.key)

    def _record(self, name, ms, plain_ms, library_ms, bytes_, ops_s,
                batch=None):
        """Times of one kernel beside its bound: the main entry, or with
        ``batch`` an extra ``batch<N>`` entry of the same kernel."""
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops_s * 1e3
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        if batch is None:
            self.kernels[name] = rec
        else:
            self.kernels[name][f"batch{batch}"] = rec
        print(f"time {name}{'' if batch is None else f' batch {batch}'}: "
              f"{ms * 1e3:.2f} us/launch, twin {plain_ms * 1e3:.1f} us, "
              f"library {library_ms * 1e3:.2f} us, bound "
              f"{max(t_bytes, t_ops) * 1e3:.4f} us ({rec['bound_by']}) on "
              f"{self.card}")

    def kernels_line(self) -> str:
        rows = []
        for name, (rep, source) in KERNELS.items():
            e = self.err[name]
            rows.append(dict(
                name=name, route="cuda", source=source, replaces=rep,
                launches=self.launches[name],
                max_abs_err=max(v for v in e.values() if v is not None),
                **{f"max_abs_err_{m}": v for m, v in e.items()},
                **self.kernels[name]))
        return json.dumps({"kernels": rows})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import repro_torch
    except ImportError:
        repro_torch = None
    if repro_torch is None or ROOT not in pathlib.Path(
            repro_torch.__file__).resolve().parents:
        print("chip_smoke: run from a checkout (src/repro_torch not found "
              "beside this script)", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch)
    t_all = time.perf_counter()
    for phase in (smoke.build, smoke.twins, smoke.main_path,
                  smoke.baseline_twins, smoke.fixed_matrix, smoke.times,
                  smoke.fixed_times):
        t0 = time.perf_counter()
        print(f"== {phase.__name__}")
        try:
            phase()
        except Exception:                      # report, then fail the run
            traceback.print_exc()
            smoke.failures.append(f"phase {phase.__name__} raised")
            break
        print(f"== {phase.__name__}: {time.perf_counter() - t0:.1f} s")
    print(f"total {time.perf_counter() - t_all:.1f} s")
    if smoke.failures:
        print(f"chip_smoke FAILED: {smoke.failures}", file=sys.stderr)
        return 1
    print(f"requests/s (LARGE_1024 server, 16 slots, {BURSTS} bursts): "
          f"{smoke.requests_per_s:.2f} on {smoke.card}")
    print(smoke.kernels_line())
    print(smoke.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
