#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. builds the CUDA rollout kernels from ``src/repro_torch`` (nvcc, into
   ``build/``) and prints the build time, PyTorch/CUDA versions and the
   card's name and power limit;
2. holds both rollout kernels (B1 generic, B2 specialized) and the readout
   kernel against their plain PyTorch twins on the card, on dim-256 /
   block-64 matrices (one with whole zero blocks) over {fp32, int8} x
   {resident, pipelined} x batch {3, 16}, with readout and final state;
3. drives the main serving path at ``LARGE_1024`` (dim 1024, int8-CSD):
   ``init_esn`` -> ``fit_readout`` -> an ``AsyncReservoirServer`` with 16
   slots answering a burst of 24 requests in 32-step chunks (five bursts,
   each on a fresh server), the same requests one-shot through
   ``submit_many`` (chunked must equal one-shot bit for bit), and through
   the generic kernel (``specialize=False``, must equal the specialized
   one bit for bit);
4. serves fp32 requests at ``PAPER_BASELINE`` (dim 800) with both kernels,
   then holds both against their twins at that shape (a ragged last
   column block);
5. times each kernel per launch at the LARGE_1024 serve shape with CUDA
   events, beside its plain twin, one PyTorch call computing the same
   product, and the least time the card could take (its bound).

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

REPLACES = {
    "specialized_rollout":
        "src/repro/kernels/reservoir_rollout/specialized.py:162",
    "reservoir_rollout":
        "src/repro/kernels/reservoir_rollout/reservoir_rollout.py:117",
    "rollout_readout":
        "src/repro/kernels/reservoir_rollout/specialized.py:142",
}
SOURCE = "src/repro_torch/kernels/reservoir_rollout/csrc/rollout.cu"


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
    return float((a.float() - b.float()).abs().max().item())


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        # max |kernel - twin| per kernel and mode; None until a check ran
        self.err = {k: {"int8": None, "fp32": None} for k in REPLACES}
        self.failures: list[str] = []
        self.kernels: dict = {}
        self.card = ""

    def check(self, cond: bool, what: str) -> None:
        if not cond:
            self.failures.append(what)
            print(f"FAIL: {what}")

    def note_err(self, kernel, mode, value) -> None:
        old = self.err[kernel][mode]
        self.err[kernel][mode] = value if old is None else max(old, value)

    # -- phase 1 -------------------------------------------------------------
    def build(self):
        torch = self.torch
        from repro_torch.kernels.reservoir_rollout import _cuda
        t0 = time.perf_counter()
        _cuda.library()
        info = _cuda.build_info()
        self.card = gpu_name_power()
        print(f"build: {time.perf_counter() - t0:.2f} s ({info['path']})")
        for line in info["log"].splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())
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
                   "reservoir_rollout": reservoir_rollout,
                   "rollout_readout": rollout_readout}
        for fn in counted.values():
            fn.launches = 0

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
        before, chunks = specialized_rollout.launches, 0
        for _ in range(BURSTS):
            # stats of its own: the engine's would add up across bursts
            srv = AsyncReservoirServer(eng, n_slots=16, chunk_steps=32,
                                       stats=ServeStats())
            for i, spec in enumerate(specs):
                srv.submit(spec, arrival_time=0.001 * i)
            t0 = time.perf_counter()
            res = srv.run()
            torch.cuda.synchronize()
            bursts.append(time.perf_counter() - t0)
            chunks += srv.stats.chunks
            served.append(res)
            self.check(len(res) == len(specs) and all(
                r.status == "ok" and r.preds.shape == (n, 1)
                and np.isfinite(r.preds).all()
                for r, n in zip((res[i] for i in range(len(specs))),
                                lengths)),
                "server answered every request")
        b2_served = specialized_rollout.launches - before
        self.chunk_launches = b2_served / max(chunks, 1)
        self.check(b2_served > 0, "B2 launched by the server")
        wall = sum(bursts)
        n_req = BURSTS * len(specs)
        print(f"server: {BURSTS} bursts x {len(specs)} requests, "
              f"{BURSTS * int(lengths.sum())} steps, {chunks} chunks, "
              f"{wall:.4f} s wall = {n_req / wall:.1f} requests/s, "
              f"{BURSTS * lengths.sum() / wall:.0f} steps/s "
              f"({b2_served} B2 launches, {self.chunk_launches:.0f} per "
              f"chunk) on {self.card}")
        print("  per burst requests/s: "
              + ", ".join(f"{len(specs) / w:.1f}" for w in bursts))

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
        print("main-path launches:", self.launches)
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
        torch = self.torch
        from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
        from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
            reservoir_rollout_plain, rollout_readout)
        from repro_torch.kernels.reservoir_rollout.specialized import (
            SpecializedRollout, specialized_rollout_plain)
        params = self.params_1024
        cfg = params.config
        plan = params.w.plan()
        b, t_steps, reps = 16, 64, 5
        gen = torch.Generator(device="cpu").manual_seed(5)
        u = torch.randn((t_steps, b, 1), generator=gen).to(self.dev)
        x0 = (0.5 * torch.randn((b, cfg.reservoir_dim),
                                generator=gen)).to(self.dev)
        ops = {
            "specialized_rollout": (SpecializedRollout(
                plan, params.w_in, leak=cfg.leak, mode="int8",
                w_out=params.w_out, device=self.dev),
                specialized_rollout_plain),
            "reservoir_rollout": (FusedRollout(
                plan, params.w_in, leak=cfg.leak, mode="int8",
                w_out=params.w_out, device=self.dev), reservoir_rollout_plain),
        }

        def timed(fn, n):
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

        dense = params.w.dense_f32(device=self.dev)
        x = x0.clone()
        lib_step = timed(lambda: x @ dense, 200)
        bk = plan.block
        kw = dict(want_states=True, want_preds=False, want_final=False)
        # in turns (B2, B1, B1, B2): the minimum of each kernel's two runs
        runs = {name: [] for name in ops}
        for name in ("specialized_rollout", "reservoir_rollout",
                     "reservoir_rollout", "specialized_rollout"):
            op = ops[name][0]
            runs[name].append(timed(lambda: op(u, x0, **kw), reps) / t_steps)
        print("per-step runs (ms):", runs)
        self._profile(ops, u, x0, kw)
        for name, (op, _plain) in ops.items():
            # host side alone: the loop's enqueue time, no device sync
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op(u, x0, **kw)
            host = (time.perf_counter() - t0) / t_steps
            torch.cuda.synchronize()
            print(f"  {name}: host enqueue {host * 1e6:.1f} us/step")
        for name, (op, plain) in ops.items():
            per_step = min(runs[name])
            common = dict(leak=op.leak, smax=op.smax,
                          recur_scale=op.recur_scale, readout_every=1, **kw)
            short = u[:8]
            plain_step = timed(lambda: plain(short, op.tables, op.w_in, x0,
                                             None, **common), 2) / 8
            got = op(u[:16], x0, **kw)
            ref = plain(u[:16], op.tables, op.w_in, x0, None, **common)
            d = maxdiff(got, ref)
            self.note_err(name, "int8", d)
            self.check(d == 0.0, f"{name} vs twin at LARGE_1024: {d:.3g}")
            tb = op.tables
            n_mm = tb.n_matmul_terms
            bytes_ = (n_mm * bk * bk + tb.n_digits * 16
                      + tb.terms.numel() * 4 + 2 * b * cfg.reservoir_dim * 4
                      + b * cfg.input_dim * 4
                      + cfg.input_dim * cfg.reservoir_dim * 4)
            int_ops = 2 * n_mm * bk * bk * b + 2 * tb.n_digits * b
            f32_ops = b * cfg.reservoir_dim * (2 * cfg.input_dim + 6)
            self._record(name, per_step, plain_step, lib_step, bytes_,
                         int_ops / INT8_OPS_PER_S + f32_ops / FP32_FLOPS_PER_S)
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

    def _profile(self, ops, u, x0, kw):
        """Device time per kernel launch from a torch.profiler trace (the
        CUDA-event times above include any gaps between launches)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            for op, _plain in ops.values():
                op(u[:16], x0, **kw)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if "kernel" in e.key and e.count]
        if not rows:
            print("profiler: no device kernels recorded")
        for e in rows:
            print(f"  profiler {e.key[:60]}: {e.count} launches, "
                  f"{e.device_time_total / e.count:.2f} us device time each")

    def _record(self, name, ms, plain_ms, library_ms, bytes_, ops_s):
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops_s * 1e3
        self.kernels[name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"time {name}: {ms * 1e3:.2f} us/launch, twin "
              f"{plain_ms * 1e3:.1f} us, library {library_ms * 1e3:.2f} us, "
              f"bound {max(t_bytes, t_ops) * 1e3:.4f} us "
              f"({self.kernels[name]['bound_by']}) on {self.card}")

    def kernels_line(self) -> str:
        rows = []
        for name, rep in REPLACES.items():
            e = self.err[name]
            rows.append(dict(
                name=name, route="cuda", source=SOURCE, replaces=rep,
                launches=self.launches[name],
                max_abs_err=max(v for v in e.values() if v is not None),
                max_abs_err_int8=e["int8"],
                max_abs_err_fp32=e["fp32"], **self.kernels[name]))
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
                  smoke.baseline_twins, smoke.times):
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
