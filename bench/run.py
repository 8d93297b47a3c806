"""Run one cell of the port's benchmark on the GPU this process is on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), ``breakdown`` with ``--trace 1``, and last
``checks``: each number the correctness check compared beside its limit,
which also end standard error.  Exits non-zero without a result when no
CUDA device is present (it never falls back to the CPU), when the port is
not beside the benchmark, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is,
    as a whole name, JAX's, Flax's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"bench: the port (src/repro_torch) is not under {ROOT}",
              file=sys.stderr)
        return 3
    # the port builds its kernels into <checkout>/build (kernels/_build.py)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("bench: no CUDA device; the benchmark runs only on the GPU",
              file=sys.stderr)
        return 2

    from bench.harness import load_cell, run_cell
    cell = load_cell(args.workload, ROOT)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device=torch.device("cuda", 0), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"bench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 4
    err = out.pop("_stderr")
    out.pop("_control", None)
    for line in err:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
