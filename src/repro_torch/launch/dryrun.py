"""Multi-pod dry-run driver.

For every (architecture x input-shape x mesh) cell: build the step function
on abstract inputs (``launch/steps.lower_cell``), run it once on rank 0 of
a fake process group of the production mesh's size (256 ranks, or 512
multi-pod) on meta tensors (no allocation, no data), and record the
step's per-device memory, its FLOPs and collective bytes (the HLO walker's
keys, from ``launch/hlo_cost.StepTally``) to a per-cell JSON under
``results/dryrun_torch/`` (the JAX package writes ``results/dryrun/``; the
records keep its keys, so either package's reports read either's).

A process holds one process group, of one size: cells run in subprocesses
(one per cell) in driver mode, and ``--cell`` runs one cell inline inside a
fake world of its own.  Where the JAX package saves the compiled HLO text
(``.hlo.txt.gz``), the port has none: it saves the step's op table
(``.ops.txt.gz``: per-device FLOPs, collective bytes by kind, local
operations, memory), and ``--no-hlo`` skips it.

Usage:
  python -m repro_torch.launch.dryrun                 # all pending cells
  python -m repro_torch.launch.dryrun --cell qwen3-32b train_4k --multi-pod
  python -m repro_torch.launch.dryrun --list          # show cell status
"""

import argparse
import gzip
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def cell_path(arch: str, shape: str, multi_pod: bool,
              variant: str = "") -> Path:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    suffix = f"__{variant}" if variant else ""
    return RESULTS / mesh_name / f"{arch}__{shape}{suffix}.json"


def parse_overrides(pairs):
    out = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def run_cell_inline(arch: str, shape_name: str, multi_pod: bool,
                    save_hlo: bool = True, overrides: dict | None = None,
                    variant: str = "") -> dict:
    """One cell's record; the fake world of the production mesh's size
    lives for the call."""
    from repro_torch.configs import SHAPES, get_config, supports_shape
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.launch.steps import lower_cell
    from repro_torch.models.transformer import LM

    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    out: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "n_devices": 512 if multi_pod else 256,
                 "variant": variant, "overrides": overrides or {}}
    ok, why = supports_shape(cfg, shape)
    if not ok:
        out["status"] = "skipped"
        out["reason"] = why
        return out

    with fake_world(out["n_devices"]):
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.time()
        lowered, meta = lower_cell(cfg, shape, mesh)
        out["t_lower_s"] = round(time.time() - t0, 1)
        t0 = time.time()
        compiled = lowered.compile()
        out["t_compile_s"] = round(time.time() - t0, 1)
    out.update(meta)
    out["memory_per_device"] = compiled.memory_analysis()
    ca = compiled.cost_analysis()
    out["cost_analysis_raw"] = {
        "flops": float(ca["flops"]),
        "bytes_accessed": -1.0,
        "note": "DTensor products at their global shapes (all ranks' "
                "work; local regions' plain products are not in it); see "
                "hlo_walk for the per-device numbers",
    }
    t0 = time.time()
    out["hlo_walk"] = compiled.walk()
    out["t_walk_s"] = round(time.time() - t0, 1)
    out["param_count"] = LM(cfg, device="meta").param_count()
    out["status"] = "ok"

    if save_hlo:
        p = cell_path(arch, shape_name, multi_pod, variant)
        p.parent.mkdir(parents=True, exist_ok=True)
        with gzip.open(p.with_suffix(".ops.txt.gz"), "wt") as f:
            f.write(compiled.op_table())
    return out


def all_cells():
    from repro_torch.configs import SHAPES, list_archs
    for arch in list_archs():
        for shape in SHAPES:
            for multi_pod in (False, True):
                yield arch, shape, multi_pod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", nargs=2, metavar=("ARCH", "SHAPE"))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--no-hlo", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--variant", default="")
    ap.add_argument("--override", action="append", default=[],
                    metavar="FIELD=VALUE")
    args = ap.parse_args()

    if args.list:
        for arch, shape, mp in all_cells():
            p = cell_path(arch, shape, mp)
            status = "-"
            if p.exists():
                status = json.loads(p.read_text()).get("status", "?")
            print(f"{arch:22s} {shape:12s} {'2x16x16' if mp else '16x16':8s} {status}")
        return

    if args.cell:
        arch, shape = args.cell
        p = cell_path(arch, shape, args.multi_pod, args.variant)
        if p.exists() and not args.force:
            print(f"cached: {p}")
            return
        try:
            res = run_cell_inline(arch, shape, args.multi_pod,
                                  save_hlo=not args.no_hlo,
                                  overrides=parse_overrides(args.override),
                                  variant=args.variant)
        except Exception as e:
            res = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if args.multi_pod else "16x16",
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(res, indent=2))
        print(json.dumps({k: v for k, v in res.items()
                          if k not in ("traceback",)}, indent=2))
        return

    # driver mode: subprocess per pending cell
    for arch, shape, mp in all_cells():
        p = cell_path(arch, shape, mp)
        if p.exists() and not args.force:
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--cell", arch, shape]
        if mp:
            cmd.append("--multi-pod")
        if args.no_hlo:
            cmd.append("--no-hlo")
        if args.force:
            cmd.append("--force")
        print(f"=== {arch} {shape} {'2x16x16' if mp else '16x16'} ===",
              flush=True)
        t0 = time.time()
        try:
            subprocess.run(cmd, timeout=args.timeout, check=False)
        except subprocess.TimeoutExpired:
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(json.dumps({
                "arch": arch, "shape": shape,
                "mesh": "2x16x16" if mp else "16x16",
                "status": "timeout", "timeout_s": args.timeout}))
        print(f"    ({time.time() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
