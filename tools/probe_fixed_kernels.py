#!/usr/bin/env python3
"""Probes of the fixed-matrix kernels B3 (``bitplane_gemv``), B4
(``bcsr_matmul``) and B5 (``reservoir_step``) on one NVIDIA GPU, at
LARGE_1024 (dim 1024, int8-CSD, block 128; the matrix of
``chip_smoke.py``; B5 on its dense fp32 form).

Run from the root of a checkout: ``python3 tools/probe_fixed_kernels.py``
(``--only b5`` for one kernel, ``--only copy`` for the copy probe).  It
builds what it needs with ``nvcc`` into ``build/probe/`` and prints

1. ``copy``: how fast 128 thread blocks move 64 KiB each into shared
   memory (``tools/copy_probe.cu``): device time per launch (profiler) and
   the median SM clock cycles, from each block's start, at which its
   barriers were set up, its copies issued and its bytes landed;
2. ``sweep``: B3's device time per launch with its shares cut into 1, 2,
   4 or 8 bulk-copy stages, and B4's on grids of (cluster parts, columns
   per block), batch 16 and 1, each result checked against the exact
   product (B3) or the plain twin (B4, within 1e-4); B5's on grids of
   (columns per block, cluster parts) at batch 16 and 1 and on register
   tiles (columns x batch rows per thread) at batch 16, each checked
   against the plain twin (within 1e-4);
3. ``phases``: the same kind of cycle counts as in 1 at points inside
   instrumented copies of the three kernels (the repository's sources
   with ``clock64`` stores added), batch 16 and 1.

Every line names the card and its power limit.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
OUT = ROOT / "build" / "probe"


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def build(source: pathlib.Path, name: str, edits=()) -> ctypes.CDLL:
    """Compile ``source`` (with textual ``edits``) into build/probe."""
    from repro_torch.kernels import _build
    text = source.read_text()
    text = text.replace('#include "../../', f'#include "{KERNELS}/')
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{source.name}: probe point not found: {old}")
        text = text.replace(old, new, 1)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{ROOT}", "-o", str(so),
           str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(so))


def device_us(torch, call, key: str, n: int = 30) -> float:
    """Device µs per call of the CUDA kernels whose name holds ``key``, one
    launch per call; a profile that did not record all ``n`` launches is
    taken again (at most three times)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and key in e.key]
        if sum(e.count for e in rows) == n:
            return sum(e.device_time_total for e in rows) / n
    raise RuntimeError(f"the profiler did not record {n} launches of {key}")


# -- 1. copies ---------------------------------------------------------------
def copies(torch, tag: str) -> None:
    lib = build(ROOT / "tools" / "copy_probe.cu", "copy_probe")
    lib.copy_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p]
    blocks, share = 128, 65536
    dev = torch.device("cuda")
    src = torch.randint(0, 255, (blocks * share,), dtype=torch.uint8,
                        device=dev)
    hot = torch.randint(0, 255, (16384,), dtype=torch.uint8, device=dev)
    ts = torch.zeros((blocks, 4), dtype=torch.int64, device=dev)
    out = torch.zeros(blocks, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    names = {1: "4 bulk copies of 16 KiB", 2: "1 bulk copy of 64 KiB",
             3: "plain 16-byte loads", 4: "4 bulk copies + hot 16 KiB reads"}
    for method in (1, 2, 3, 4, 1):
        def call():
            rc = lib.copy_probe(src.data_ptr(), hot.data_ptr(), method,
                                blocks, share, ts.data_ptr(), out.data_ptr(),
                                stream)
            if rc:
                raise RuntimeError(f"copy_probe failed with {rc}")
        us = device_us(torch, call, "copy_kernel")
        t = ts.cpu().numpy()
        print(f"copy {names[method]}: {us:.3f} us device; cycles: barriers "
              f"{np.median(t[:, 0]):.0f}, issued {np.median(t[:, 1]):.0f}, "
              f"landed {np.median(t[:, 2]):.0f} (max {t[:, 2].max()}) "
              f"on {tag}")


# -- 2. phases -------------------------------------------------------------
def stamp(slot) -> str:
    return ("if (threadIdx.x == 0) g_ts[(blockIdx.y * gridDim.x + "
            f"blockIdx.x) * 32 + {slot}] = clock64();")


HEADER = ("__device__ long long* g_ts;\n"
          "extern \"C\" int set_ts(void* p) { return (int)cudaMemcpyToSymbol("
          "g_ts, &p, sizeof(p)); }\n")

B3_POINTS = [
    ("  const int loads = resident ? p.n_stages : n_tiles * p.n_stages;",
     "  const int loads = resident ? p.n_stages : n_tiles * p.n_stages;\n"
     + stamp(0)),
    ("                bar0 + 8 * q);\n    }\n",
     "                bar0 + 8 * q);\n    }\n" + stamp(1) + "\n"),
    ("    uint32_t* mine = red + warp * kRows * cw;",
     "    uint32_t* mine = red + warp * kRows * cw;\n    if (t == 0) "
     + stamp(2)),
    ("      const unsigned char* st = ring + (size_t)buf * p.stage_bytes;",
     "      if (t == 0 && s == 0) " + stamp(3)
     + "\n      const unsigned char* st = ring + (size_t)buf * p.stage_bytes;"),
    ("    __syncthreads();\n    // the warps' partials in warp order",
     "    if (t == 0) " + stamp(4) + "\n    __syncthreads();\n    if (t == 0) "
     + stamp(5) + "\n    // the warps' partials in warp order"),
]
B3_NAMES = ["copy issued", "x staged", "share landed", "warp 0's MMAs done",
            "all warps done"]

B4_POINTS = [
    ("  const uint32_t bar = smem_u32(smem);\n",
     "  const uint32_t bar = smem_u32(smem);\n" + stamp(0) + "\n"),
    ("      bulk_load(smem_u32(tiles), p.blob + m.x, k_all * cw * 4, bar);\n"
     "    }\n",
     "      bulk_load(smem_u32(tiles), p.blob + m.x, k_all * cw * 4, bar);\n"
     "    }\n" + stamp(1) + "\n"),
    ("  if (k_all > 0) mbar_wait(bar, 0);",
     stamp(2) + "\n  if (k_all > 0) mbar_wait(bar, 0);\n" + stamp(3)),
    ("  // the row lanes: a fixed butterfly",
     stamp(4) + "\n  // the row lanes: a fixed butterfly"),
    ("  if (split) {\n    // one cluster barrier",
     stamp(5) + "\n  if (split) {\n    // one cluster barrier"),
    ("    cg::this_cluster().sync();\n",
     "    cg::this_cluster().sync();\n" + stamp(6) + "\n"),
    ("      store(p.y, (size_t)(b0 + b) * p.ld_y + c0 + (idx - b * cw), sum);\n"
     "    }\n  }\n}\n",
     "      store(p.y, (size_t)(b0 + b) * p.ld_y + c0 + (idx - b * cw), sum);\n"
     "    }\n  }\n" + stamp(7) + "\n}\n"),
]
B4_NAMES = ["copy issued", "x staged", "share landed", "thread 0's FMAs done",
            "sums pushed", "cluster barrier", "own outputs summed"]

B5_POINTS = [
    ("  const uint32_t bar_in = bar + 8 * kStages;      // the inbox's\n",
     "  const uint32_t bar_in = bar + 8 * kStages;\n" + stamp(0) + "\n"),
    ("    mbar_expect_tx(bar_in, p.parts * live * 4);\n",
     "    mbar_expect_tx(bar_in, p.parts * live * 4);\n" + stamp(1) + "\n"),
    ("  __syncthreads();\n\n  // products:",
     "  __syncthreads();\n" + stamp(2) + "\n\n  // products:"),
    ("    mbar_wait(bar + 8 * s, 0);\n",
     "    mbar_wait(bar + 8 * s, 0);\n    if (s == 0) " + stamp(3) + "\n"),
    ("  // the row lanes: a fixed butterfly",
     stamp(4) + "\n  // the row lanes: a fixed butterfly"),
    ("  // Every sum of a quad", stamp(5) + "\n  // Every sum of a quad"),
    ("  asm volatile(\"barrier.cluster.wait.aligned;\" ::: \"memory\");\n",
     "  asm volatile(\"barrier.cluster.wait.aligned;\" ::: \"memory\");\n"
     + stamp(6) + "\n"),
    ("  // the epilogue, once every part's sums",
     stamp(7) + "\n  // the epilogue, once every part's sums"),
    ("  mbar_wait(bar_in, 0);\n",
     "  mbar_wait(bar_in, 0);\n" + stamp(8) + "\n"),
    ("  }\n}\n\ntemplate <int BT, int CW>\nint launch(",
     "  }\n" + stamp(9) + "\n}\n\ntemplate <int BT, int CW>\nint launch("),
]
B5_NAMES = ["barriers set up, copy issued", "x staged and epilogue inputs "
            "loaded", "first stage landed", "thread 0's FMAs done", "butterfly",
            "cluster start wait", "sums sent", "own inbox landed",
            "epilogue done"]


def instrumented(src: str, name: str, points) -> ctypes.CDLL:
    edits = [("using namespace hopper;", "using namespace hopper;\n" + HEADER),
             *points]
    return build(KERNELS / src, name, edits)


def phases(torch, ops, xs, tag: str, only) -> None:
    from repro_torch.kernels.bcsr_matmul import bcsr_matmul as b4
    from repro_torch.kernels.bitplane_gemv import bitplane_gemv as b3
    from repro_torch.kernels.reservoir_step import reservoir_step as b5
    ts = torch.zeros((4096, 32), dtype=torch.int64, device="cuda")
    fr = ops["b5"]
    u = xs["u"]
    kernels = {
        "b3": ("B3", b3, "bitplane_gemv",
               "bitplane_gemv/csrc/bitplane_gemv.cu", B3_POINTS, B3_NAMES,
               ops["b3"].packed, lambda x, pk: b3.bitplane_gemv(x, pk),
               lambda pk, bt: pk.grid.n_blocks),
        "b4": ("B4", b4, "bcsr_matmul", "bcsr_matmul/csrc/bcsr_matmul.cu",
               B4_POINTS, B4_NAMES, ops["b4"].packed,
               lambda x, pk: b4.bcsr_matmul(x, pk),
               lambda pk, bt: pk.grid.n_blocks),
        "b5": ("B5", b5, "reservoir_step",
               "reservoir_step/csrc/reservoir_step.cu", B5_POINTS, B5_NAMES,
               fr.packed,
               lambda x, pk: b5.reservoir_step(
                   x, pk, u[:x.shape[0]], fr.w_in, leak=fr.leak),
               lambda pk, bt: pk.grid(bt).n_blocks)}
    for key in [k for k in kernels if k in only]:
        label, mod, entry, src, points, names, packed, call, blocks = \
            kernels[key]
        lib = instrumented(src, f"{entry}_phases", points)
        fn = getattr(lib, entry)
        fn.argtypes = mod.LIBRARY.entries[entry]
        if lib.set_ts(ctypes.c_void_p(ts.data_ptr())):
            raise RuntimeError("set_ts failed")
        packed = dataclasses.replace(packed, fn=fn)
        for batch in (16, 1):
            x = xs[label][:batch]
            for _ in range(5):
                call(x, packed)
            torch.cuda.synchronize()
            ts.zero_()
            call(x, packed)
            torch.cuda.synchronize()
            t = ts[:blocks(packed, batch)].cpu().numpy()
            rel = t - t[:, :1]
            cols = ", ".join(f"{nm} {np.median(rel[:, i + 1]):.0f}"
                             for i, nm in enumerate(names))
            print(f"phases {label} b{batch} (median cycles from each "
                  f"block's start): {cols} on {tag}")


# -- 3. sweeps -------------------------------------------------------------
def sweeps(torch, plan, ops, xs, exact, tag: str, only, b5_libs) -> None:
    if "b3" in only:
        sweep_b3(torch, plan, ops["b3"], xs, exact, tag)
    if "b4" in only:
        sweep_b4(torch, ops["b4"], xs, tag)
    if "b5" in only:
        sweep_b5(torch, ops["b5"], xs, tag)
        variants_b5(torch, ops["b5"], xs, tag, b5_libs)


def sweep_b3(torch, plan, op3, xs, exact, tag: str) -> None:
    from repro_torch.kernels.bitplane_gemv import bitplane_gemv as b3
    for sc in (32, 16, 8, 4):
        g = dataclasses.replace(op3.packed.grid, sc=sc)
        n_buf = g.buffers(True)
        pk = dataclasses.replace(
            op3.packed, grid=g,
            blob=torch.as_tensor(b3.pack_blob(plan.digits, g), device="cuda"),
            launch={True: (n_buf, g.smem(n_buf, True)), False: None})
        res = []
        for batch in (16, 1):
            x = xs["B3"][:batch]
            ok = torch.equal(b3.bitplane_gemv(x, pk), exact[:batch])
            us = device_us(torch, lambda: b3.bitplane_gemv(x, pk),
                           "bitplane_gemv_kernel")
            res.append(f"b{batch} {us:.3f} us (exact {ok})")
        print(f"sweep B3 {g.n_stages} stage(s) of {g.stage_bytes} B: "
              + "; ".join(res) + f" on {tag}")


def sweep_b4(torch, op4, xs, tag: str) -> None:
    from repro_torch.kernels.bcsr_matmul import bcsr_matmul as b4
    lay = op4.layout
    want = {b: b4.bcsr_matmul_plain(xs["B4"][:b], op4.tiles, op4.col_ptr,
                                    op4.tile_rows, op4.rows_pad)
            for b in (16, 1)}
    longest = int(np.diff(lay.col_ptr).max())
    for parts, cw in ((8, 128), (8, 64), (4, 64), (4, 32), (2, 16), (1, 16),
                      (1, 8)):
        g = dataclasses.replace(op4.packed.grid, parts=parts, cw=cw,
                                slices=lay.block // cw,
                                max_tiles=-(-longest // parts))
        blob, meta = b4.pack_share_blob(lay.data, lay.col_ptr, lay.rows, g)
        pk = dataclasses.replace(
            op4.packed, grid=g, smem={},
            blob=torch.as_tensor(blob, device="cuda"),
            meta=torch.as_tensor(meta, device="cuda"))
        res = []
        for batch in (16, 1):
            x = xs["B4"][:batch]
            err = (b4.bcsr_matmul(x, pk) - want[batch]).abs().max().item()
            us = device_us(torch, lambda: b4.bcsr_matmul(x, pk),
                           "bcsr_matmul_kernel")
            res.append(f"b{batch} {us:.3f} us (max |diff| {err:.2g})")
        print(f"sweep B4 {g.n_blocks} blocks of {cw} columns, clusters of "
              f"{parts}: " + "; ".join(res) + f" on {tag}")


B5_GRIDS = ((8, 128), (8, 64), (4, 64), (4, 32), (2, 32), (2, 16), (1, 16),
            (1, 8))                                   # (parts, cw)


# B5 design alternatives, each a textual edit of csrc/reservoir_step.cu
_SEND = ("KLW lanes\n    if (klw == 0) {\n#pragma unroll\n"
         "      for (int j = 0; j < RB; ++j) {\n#pragma unroll\n"
         "        for (int h = 0; h < H; ++h) {\n")
_TILE = ("  constexpr int TC = 4;\n"
         "  constexpr int RB = BT < 4 ? BT : BT == 16 ? 8 : 4;\n")
B5_VARIANTS = {
    "as committed": [],
    "4 x 4 register tile": [(_TILE, _TILE.replace("BT == 16 ? 8 : 4", "4"))],
    "8 x 4 register tile": [(_TILE, _TILE.replace("TC = 4", "TC = 8")
                             .replace("BT == 16 ? 8 : 4", "4"))],
    "4 x 16 register tile": [(_TILE, _TILE.replace("BT == 16 ? 8 : 4",
                                                   "BT"))],
    "512 threads per block": [
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "two bulk copies per share": [
        ("constexpr int kStages = 1;", "constexpr int kStages = 2;")],
    "four bulk copies per share": [
        ("constexpr int kStages = 1;", "constexpr int kStages = 4;")],
    "cluster wait just before the sends": [
        ("  // every block of the cluster has started and set up its barriers "
         "(a\n  // wait that overlaps the share's landing)\n  asm volatile("
         "\"barrier.cluster.wait.aligned;\" ::: \"memory\");\n", ""),
        ("  if constexpr (GROUPS == 1) {\n",
         "  asm volatile(\"barrier.cluster.wait.aligned;\" ::: \"memory\");"
         "\n  if constexpr (GROUPS == 1) {\n")],
    "sends split over the lanes of each butterfly": [
        (_SEND, _SEND.replace("    if (klw == 0) {", "    {").replace(
            "h < H; ++h) {", "h < H; ++h) if ((j * H + h) % KLW == klw) {"))],
}


def build_b5_variants() -> list:
    """Every variant of B5_VARIANTS built and loaded (the kernel renamed,
    so the profiler keeps the copies apart).  Done before the first
    profile: the profiler records no launch of a library loaded after
    it first ran."""
    rename = [("reservoir_step_kernel(", "b5variant_kernel("),
              ("reservoir_step_kernel<BT, CW>;", "b5variant_kernel<BT, CW>;")]
    src = KERNELS / "reservoir_step" / "csrc" / "reservoir_step.cu"
    with ThreadPoolExecutor(len(B5_VARIANTS)) as pool:   # one nvcc each
        return list(pool.map(
            lambda ie: build(src, f"b5_variant{ie[0]}", [*rename, *ie[1]]),
            enumerate(B5_VARIANTS.values())))


def variants_b5(torch, fr, xs, tag: str, libs) -> None:
    """The B5 variants (``libs``, from build_b5_variants) on the picker's
    grids, batch 16 and 1, each launch given room for 8 groups of row
    lanes' sums (a wider tile sums more of them in shared memory), each
    checked against the plain twin."""
    from repro_torch.kernels._launch import MAX_SMEM
    from repro_torch.kernels.reservoir_step import reservoir_step as b5

    @dataclasses.dataclass(frozen=True)
    class Roomy(b5.StepGrid):
        smem = property(lambda self: min(
            MAX_SMEM, b5.StepGrid.smem.fget(self)
            + 8 * self.b_tile * self.cw * 4))

    u = xs["u"]
    grids = {bt: Roomy(**dataclasses.asdict(g))
             for bt, g in fr.packed.grids.items()}
    for label, lib in zip(B5_VARIANTS, libs):
        fn = lib.reservoir_step
        fn.argtypes = b5.LIBRARY.entries["reservoir_step"]
        pk = dataclasses.replace(fr.packed, fn=fn, grids=grids)
        res = []
        for batch in (16, 1):
            x = xs["B5"][:batch]
            want = b5.reservoir_step_plain(x, fr.w, u[:batch], fr.w_in,
                                           leak=fr.leak)
            call = lambda: b5.reservoir_step(        # noqa: E731
                x, pk, u[:batch], fr.w_in, leak=fr.leak)
            err = (call() - want).abs().max().item()
            us = device_us(torch, call, "b5variant_kernel")
            res.append(f"b{batch} {us:.3f} us (max |diff| {err:.2g}"
                       f"{'' if err <= 1e-4 else ', FAILS 1e-4'})")
        print(f"variant B5 {label}: " + "; ".join(res) + f" on {tag}")


def sweep_b5(torch, fr, xs, tag: str) -> None:
    """B5 on every (parts, cw) of B5_GRIDS at batch 16, 8, 4, 2 and 1; each
    also with shared memory padded to more than half an SM's, so that no
    two blocks share an SM ("spread")."""
    from repro_torch.kernels._launch import MAX_SMEM
    from repro_torch.kernels.reservoir_step import reservoir_step as b5
    one_per_sm = 116 * 1024

    @dataclasses.dataclass(frozen=True)
    class Spread(b5.StepGrid):
        smem = property(lambda self: max(one_per_sm,
                                         b5.StepGrid.smem.fget(self)))

    u = xs["u"]
    for parts, cw in B5_GRIDS:
        res = []
        for batch in (16, 8, 4, 2, 1):
            g = dataclasses.replace(fr.packed.grid(batch), parts=parts, cw=cw)
            if g.smem > MAX_SMEM:
                res.append(f"b{batch} does not fit ({g.smem} B)")
                continue
            blobs = {(cw, parts): b5.pack_share_blob(fr.w, g)}
            x = xs["B5"][:batch]
            want = b5.reservoir_step_plain(x, fr.w, u[:batch], fr.w_in,
                                           leak=fr.leak)
            times = []
            for grid in (g, Spread(**dataclasses.asdict(g))):
                pk = dataclasses.replace(fr.packed, grids={batch: grid},
                                         blobs=blobs)
                call = lambda: b5.reservoir_step(    # noqa: E731
                    x, pk, u[:batch], fr.w_in, leak=fr.leak)
                try:
                    err = (call() - want).abs().max().item()
                except RuntimeError as e:          # a cluster not scheduled
                    times.append(f"refused ({e})")
                    continue
                us = device_us(torch, call, "reservoir_step_kernel")
                times.append(f"{us:.3f}"
                             + ("" if err <= 1e-4 else f" FAILS ({err:.2g})"))
            res.append(f"b{batch} {times[0]} us (spread {times[1]}), "
                       f"{g.smem} B smem")
        print(f"sweep B5 {g.n_blocks} blocks of {cw} columns, clusters of "
              f"{parts}: " + "; ".join(res) + f" on {tag}")


def main() -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", default=["copy", "b3", "b4", "b5"],
                    choices=["copy", "b3", "b4", "b5"])
    only = ap.parse_args().only
    if not torch.cuda.is_available():
        print("probe_fixed_kernels: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.esn_paper import LARGE_1024
    from repro_torch.core.esn import init_esn
    from repro_torch.kernels.bcsr_matmul.ops import BcsrMatmul
    from repro_torch.kernels.bitplane_gemv.ops import BitplaneGemv
    from repro_torch.kernels.reservoir_step.ops import FusedReservoir
    torch.backends.cuda.matmul.allow_tf32 = False     # the twin in fp32
    tag = card()
    dev = torch.device("cuda")
    params = init_esn(LARGE_1024, device=dev)
    plan = params.w.plan()
    rng = np.random.default_rng(0)
    xs = {"B3": torch.as_tensor(rng.integers(-128, 128, (16, 1024)),
                                dtype=torch.int8, device=dev),
          "B4": torch.as_tensor(rng.standard_normal((16, 1024)),
                                dtype=torch.float32, device=dev),
          "B5": torch.as_tensor(rng.uniform(-1, 1, (16, 1024)),
                                dtype=torch.float32, device=dev),
          "u": torch.as_tensor(rng.standard_normal((16, 1)),
                               dtype=torch.float32, device=dev)}
    ops = {"b3": BitplaneGemv(plan, device=dev),
           "b4": BcsrMatmul(plan, device=dev),
           "b5": FusedReservoir(params.w.dense_f32(device=dev), params.w_in,
                                leak=LARGE_1024.leak, device=dev)}
    exact = params.w.matvec_int_exact(xs["B3"])
    b5_libs = build_b5_variants() if "b5" in only else []
    if "copy" in only:
        copies(torch, tag)
    # the sweeps first: once an instrumented copy of a kernel is loaded
    # the profiler loses launches of the kernel of the same name
    sweeps(torch, plan, ops, xs, exact, tag, only, b5_libs)
    phases(torch, ops, xs, tag, only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
