#!/usr/bin/env python3
"""Time the int8 rollout kernel (B2) in each of its two share forms, dense
MMA tiles and per-column (row, weight) lists, over synthetic densities:
the measurement behind ``_LISTS_PER_MMA_UNIT`` in
``kernels/reservoir_rollout/reservoir_rollout.py``.

Run from the root of a checkout, on a card::

    python3 tools/probe_rollout_forms.py [--dims 1024 4096]
        [--densities 0.01 0.02 0.05 0.1 0.25] [--batches 1 4 16]
        [--steps 3000] [--out build/forms_sweep.jsonl]

For each dim and density: a seeded uniform(-1, 1) matrix with that share
of nonzeros, scaled near spectral radius 0.9, compiled to int8-CSD in
blocks of 128, lowered as B2 (``SpecializedRollout``) on the default grid.
Each form is forced by setting the constant to 0 (dense) or to infinity
(lists) and packing the table anew; the grid (blocks, columns) is the same
for both.  First both forms' states and final state are held equal to the
plain twin bit for bit (T = 17, batch 3); then at each batch, CUDA events
around 4 queued launches of ``--steps`` steps, as the engine launches B2
(predictions and final state), in the order dense, lists, lists, dense;
the µs a step of each form is the mean of its two readings.  One JSON line
per (dim, density, batch) with the card's name and power limit: the grid,
the longest column's entries per lane, the dense form's MMA units per
warp, their ratio, and both forms' µs a step.  Exits 2 without a card.

Readings on an NVIDIA H100 80GB HBM3 at 700 W (torch 2.11.0+cu128), µs a
step, dense / lists; the ratio (entries / units) is what
``_LISTS_PER_MMA_UNIT`` bounds:

    dim, nz     ratio       batch 1       batch 4       batch 16
    1,024,  1 % 1/1 (1.0)   3.420/3.064   3.509/3.123   4.348/3.645
    1,024,  2 % 2/1 (2.0)   3.416/3.087   3.459/3.273   3.702/3.798
    1,024,  5 % 3/1 (3.0)   3.235/3.137   3.211/3.309   3.422/3.956
    1,024, 10 % 5/1 (5.0)   3.216/3.072   3.303/3.427   3.408/4.244
    1,024, 25 % 10/1 (10.0) 3.228/3.189   3.425/3.629   3.388/4.919
    4,096,  1 % 5/8 (0.62)  10.124/3.212  13.569/4.857  27.237/7.404
    4,096,  2 % 8/8 (1.0)   8.721/3.323   10.446/5.145  13.565/8.037
    4,096,  5 % 17/8 (2.12) 8.695/3.783   9.588/5.618   11.420/10.975
    4,096, 10 % 30/8 (3.75) 8.434/3.724   9.671/6.345   11.332/14.289
    4,096, 25 % 71/8 (8.88) 8.440/6.960   9.656/10.057  11.493/24.638

The lists won every batch at ratios 0.62, 1.0 and 2.12 and lost at batch 16
from 2.0 at dim 1,024, so a bound of 1.5 takes them only where they were at
least as fast at every batch measured; one ratio does not order the dims.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.sparse import FixedMatrix, random_sparse_matrix  # noqa: E402
from repro_torch.kernels.reservoir_rollout import \
    reservoir_rollout as rr  # noqa: E402
from repro_torch.kernels.reservoir_rollout.specialized import (  # noqa: E402
    SpecializedRollout, specialized_rollout_plain)

FORCE = {"mma": 0.0, "lists": math.inf}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def grid_of(op, form, dev, packed):
    """Put the op's table in ``form`` on its default grid (packed once a
    form, kept in ``packed``) and return the grid."""
    key = (str(dev), None)          # the key the launch's own lookup uses
    if form not in packed:
        rr._LISTS_PER_MMA_UNIT = FORCE[form]
        op.tables.grids.pop(key, None)
        rr.rollout_grid(op.tables, dev)
        packed[form] = op.tables.grids[key]
    op.tables.grids[key] = packed[form]
    grid = packed[form][0]
    assert grid.form == form, (grid.form, form)
    return grid


def us_per_step(op, u, reps=4):
    kw = dict(want_states=False, want_preds=True, want_final=True)
    op(u, **kw)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        op(u, **kw)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / reps / u.shape[0]


def check_twin(op, form, dev, rng, packed):
    """Both outputs of one launch equal the plain twin's, bit for bit."""
    grid_of(op, form, dev, packed)
    u = torch.as_tensor(rng.uniform(-1, 1, (17, 3, 1)), dtype=torch.float32,
                        device=dev)
    x0 = torch.as_tensor(0.5 * rng.standard_normal((3, op.dim)),
                         dtype=torch.float32, device=dev)
    kw = dict(want_states=True, want_final=True)
    s, f = op(u, x0, **kw)
    ps, pf = specialized_rollout_plain(
        u, op.tables, op.w_in, x0, None, leak=op.leak, smax=op.smax,
        recur_scale=op.recur_scale, **kw)
    torch.cuda.synchronize()
    return bool(torch.equal(s, ps) and torch.equal(f, pf))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dims", type=int, nargs="+", default=[1024, 4096])
    ap.add_argument("--densities", type=float, nargs="+",
                    default=[0.01, 0.02, 0.05, 0.1, 0.25])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 4, 16])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--out", default="build/forms_sweep.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    # the device as the launch names it ("cuda:0"): its grids' cache key
    dev = torch.device("cuda", torch.cuda.current_device())
    name = card()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    keep = rr._LISTS_PER_MMA_UNIT
    ok = True
    with out.open("a") as fh:
        for dim in args.dims:
            for density in args.densities:
                rng = np.random.default_rng(int(dim * 1000 + density * 1e4))
                dense = random_sparse_matrix(dim, dim, 1.0 - density, rng)
                dense *= 0.9 / math.sqrt(dim * density / 3.0)
                fm = FixedMatrix.compile(dense, weight_bits=8, mode="csd",
                                         block=128, rng=rng)
                w_in = rng.uniform(-0.5, 0.5, (1, dim)).astype(np.float32)
                w_out = (rng.standard_normal((dim, 1))
                         / math.sqrt(dim)).astype(np.float32)
                op = SpecializedRollout(fm, w_in, mode="int8", w_out=w_out,
                                        device=dev)
                packed = {}
                grids = {f: grid_of(op, f, dev, packed) for f in FORCE}
                twin = {f: check_twin(op, f, dev, rng, packed)
                        for f in FORCE}
                ok &= all(twin.values())
                per_lane = int(grids["lists"].shares.meta[:, 1].max())
                units = rr._mma_units(op.tables, grids["mma"].cw)
                for batch in args.batches:
                    u = torch.as_tensor(
                        rng.uniform(-1, 1, (args.steps, batch, 1)),
                        dtype=torch.float32, device=dev)
                    t = {"mma": [], "lists": []}
                    for form in ("mma", "lists", "lists", "mma"):
                        grid_of(op, form, dev, packed)
                        t[form].append(us_per_step(op, u))
                    row = dict(
                        card=name, dim=dim, density=density, batch=batch,
                        steps=args.steps, n_blocks=grids["mma"].n_blocks,
                        cw=grids["mma"].cw,
                        resident={f: g.resident for f, g in grids.items()},
                        share_bytes={f: g.share_bytes
                                     for f, g in grids.items()},
                        mm_terms=op.tables.n_matmul_terms,
                        digits=op.tables.n_digits,
                        list_entries=grids["lists"].shares.entries,
                        per_lane=per_lane, mma_units=units,
                        ratio=per_lane / max(1, units), twin_exact=twin,
                        us={f: sum(v) / len(v) for f, v in t.items()},
                        readings=t)
                    line = json.dumps(row)
                    print(line, flush=True)
                    fh.write(line + "\n")
    rr._LISTS_PER_MMA_UNIT = keep
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
