#!/usr/bin/env python3
"""Time the LM steps on the ``(1, 1)`` NCCL mesh against ``mesh=None`` for
two checkouts on one card, in the order A B B A.

    python3 tools/mesh_overhead.py OTHER_CHECKOUT [--out DIR]

For each checkout (``OTHER_CHECKOUT``, then this one, this one, the other)
a process of its own imports that checkout's ``chip_smoke.py`` and runs
its ``mesh`` phase ((a) stablelm-1.6b train steps, (b) olmoe-1b-7b
prefill + decode) and the ``(1, 1)`` half of its ``dryrun`` phase
((b) mistral-nemo-12b int8 prefill + decode), each step timed with CUDA
events beside the same step without a mesh.  The timing lines of each run
are printed under the checkout's name; every run's whole output goes to
``--out`` (default ``chiprun_out/mesh_overhead``).  Needs one card.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

DRIVER = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke
s = chip_smoke.Smoke(torch)
s.card = torch.cuda.get_device_name(0)
s.mesh()
s._dryrun_int8()
print("failures", s.failures)
sys.exit(1 if s.failures else 0)
"""

KEEP = ("mesh on", "(a)", "(b)", "    mesh=None:", "    the mesh:",
        "    decode ms", "    8 greedy", "failures", "FAIL")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "chiprun_out" / "mesh_overhead")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    other = args.other.resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rc = 0
    for i, root in enumerate((other, ROOT, ROOT, other)):
        name = "this" if root == ROOT else "other"
        proc = subprocess.run([sys.executable, "-c", DRIVER], cwd=str(root),
                              capture_output=True, text=True)
        out = proc.stdout + proc.stderr
        (args.out / f"{i}_{name}.log").write_text(out)
        print(f"== run {i}: {name} ({root}), exit {proc.returncode}")
        for line in out.splitlines():
            if line.startswith(KEEP):
                print(line)
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
