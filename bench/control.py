"""Readings of the correctness check for its limits, on the GPU.

    python3 bench/control.py --workload <cell> --seeds s1,s2,... --seconds <s>

For each seed, in one process: a run of the cell with a short window at
the cell's own load, judged as the benchmark judges it (the program's
``pred_err``, the lower reading), and the control, the reference computed
one precision below the configuration's (int4 for int8, TF32 for fp32)
put in the program's place on the same sampled requests (the upper
reading).  One JSON line per seed.  The benchmark's own runs do not run
it; ``bench/test_bench_check.py`` holds the control at a small size.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from bench.harness import load_cell, run_cell
    cell = load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(cell, seed, args.seconds, False,
                       device=torch.device("cuda", 0), control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": out["correct"], "attempted": out["attempted"],
            "pred_err": out["checks"]["pred_err"]["value"],
            "control_pred_err": out["_control"],
            "limit": out["checks"]["pred_err"]["limit"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
