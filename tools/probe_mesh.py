#!/usr/bin/env python3
"""Probe the LM substrate's device-mesh path on one card.

    python3 tools/probe_mesh.py [--skip-gloo] [--skip-one]

(a) Can four processes share the one card?  NCCL refuses two ranks on one
GPU, so four spawned ranks join a gloo process group (a ``FileStore``
under ``build/probe_mesh``) and try all-gather, all-reduce and
reduce-scatter on CUDA tensors of card 0, then build a 2 x 2
``DeviceMesh("cuda")``, distribute a tensor on it and redistribute it;
each outcome (or its error, or "started" where a rank died inside it) is
printed.

(b) The ``(1, 1)`` NCCL mesh of ``make_host_mesh()`` in this process
(world size 1, a file store): reduced stablelm, mistral-nemo, olmoe and
xlstm, float32, prefill + 4 decode steps and 2 train steps through the
step builders on the mesh against ``mesh=None`` from the same state, each
compared bit for bit (the largest difference printed where not), with
the ms per call of both.  Ends with one JSON line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("stablelm-1.6b", "mistral-nemo-12b", "olmoe-1b-7b", "xlstm-350m")


def _gloo_rank(rank, world, store_path, out_dir):
    import torch
    import torch.distributed as dist

    record = pathlib.Path(out_dir) / f"gloo{rank}.json"
    res = {}

    def attempt(name, fn):
        # the record is rewritten before and after each attempt, so a
        # crash (a signal, not an exception) leaves what it was doing
        res[name] = "started"
        record.write_text(json.dumps(res))
        try:
            ok = fn()
            torch.cuda.synchronize()
            res[name] = "ok" if ok else "wrong values"
        except Exception as e:  # noqa: BLE001 - the probe reports it
            res[name] = f"{type(e).__name__}: {str(e)[:300]}"
        record.write_text(json.dumps(res))

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    attempt("init_process_group", lambda: dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world) or True)

    x = torch.full((8,), float(rank + 1), device=dev)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return bool((y == sum(range(1, world + 1))).all())

    def all_gather():
        out = torch.empty(8 * world, device=dev)
        dist.all_gather_into_tensor(out, x)
        return bool((out.view(world, 8)[:, 0].cpu() == torch.arange(
            1, world + 1, dtype=torch.float32)).all())

    def reduce_scatter():
        out = torch.empty(8 // world, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return bool((out == sum(range(1, world + 1))).all())

    made = {}

    def device_mesh():
        from torch.distributed.device_mesh import DeviceMesh
        import numpy as np
        made["mesh"] = DeviceMesh("cuda", np.arange(world).reshape(
            2, world // 2), mesh_dim_names=("data", "model"))
        return True

    def distribute():
        from torch.distributed.tensor import Shard, distribute_tensor
        made["full"] = torch.arange(16.0, device=dev).reshape(4, 4)
        made["d"] = distribute_tensor(made["full"], made["mesh"],
                                      (Shard(0), Shard(1)),
                                      src_data_rank=None)
        return True

    def redistribute():
        from torch.distributed.tensor import Replicate
        back = made["d"].redistribute(made["mesh"], (Replicate(),
                                                     Replicate()))
        return bool(torch.equal(back.to_local(), made["full"]))

    for name, fn in (("all_reduce", all_reduce),
                     ("all_gather_into_tensor", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("dtensor_2x2_device_mesh", device_mesh),
                     ("dtensor_distribute", distribute),
                     ("dtensor_redistribute", redistribute)):
        attempt(name, fn)
    dist.destroy_process_group()


def probe_gloo(world: int = 4) -> dict:
    """Four ranks on card 0 over gloo (spawned in a subprocess with its
    own time limit, so a hung collective fails the probe, not the run)."""
    work = ROOT / "build" / "probe_mesh"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.glob("gloo*.json"):
        f.unlink()
    store = work / "store"
    store.unlink(missing_ok=True)
    code = ("import sys; sys.path.insert(0, %r); import probe_mesh as p; "
            "import torch.multiprocessing as mp; "
            "mp.spawn(p._gloo_rank, args=(%d, %r, %r), nprocs=%d)"
            % (str(ROOT / "tools"), world, str(store), str(work), world))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-c", code], timeout=180,
                              capture_output=True, text=True)
        rc, tail = proc.returncode, proc.stderr[-1500:]
    except subprocess.TimeoutExpired:
        rc, tail = "timeout (180 s)", ""
    res = {f.stem: json.loads(f.read_text())
           for f in sorted(work.glob("gloo*.json"))}
    out = {"world": world, "rc": rc, "seconds": time.perf_counter() - t0,
           "ranks": res}
    if rc != 0:
        out["stderr_tail"] = tail
    return out


def _equal(a, b):
    import torch
    from torch.distributed.tensor import DTensor
    a = a.full_tensor() if isinstance(a, DTensor) else a
    b = b.full_tensor() if isinstance(b, DTensor) else b
    if torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().max())


def probe_one_card(device=None) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch.configs as tcfg
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step,
                                          make_train_step)
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.transformer import LM, lm_param_shardings
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import distribute_tree

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    backend = "gloo" if device == "cpu" else "nccl"
    dist.init_process_group(backend, store=dist.FileStore(f"{tmp}/store", 1),
                            rank=0, world_size=1)
    mesh = make_host_mesh(device)
    dev = mesh.device
    out = {"mesh": mesh.shape, "backend": dist.get_backend()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, (time.perf_counter() - t0) * 1e3

    for arch in ARCHS:
        cfg = tcfg.reduced(tcfg.get_config(arch)).replace(dtype="float32")
        lm = LM(cfg, device=dev)
        rng = np.random.default_rng(0)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 20)),
                               device=dev)
        row = {}

        def params():
            return lm.init(torch.Generator(device=dev).manual_seed(0)).params

        runs = {}
        for name, m in (("none", None), ("mesh", mesh)):
            p = params()
            if m is not None:
                p = distribute_tree(p, lm_param_shardings(cfg, m))
            pre, dec = make_prefill_step(lm, m, 24), make_decode_step(lm, m)
            (logits, caches), ms_pre = timed(lambda: pre(
                p, {"tokens": toks[:, :16]}))
            outs, ms_dec = [logits], []
            for i in range(4):
                (logits, caches), ms = timed(lambda: dec(
                    p, caches, toks[:, 16 + i:17 + i]))
                outs.append(logits)
                ms_dec.append(ms)
            runs[name] = (outs, ms_pre, ms_dec)
        row["serve_max_diff"] = max(_equal(a, b) for a, b in zip(
            runs["none"][0], runs["mesh"][0]))
        row["prefill_ms"] = {k: v[1] for k, v in runs.items()}
        row["decode_ms"] = {k: v[2] for k, v in runs.items()}
        batches = [{"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (8, 17)), device=dev)} for _ in range(2)]
        train = {}
        for name, m in (("none", None), ("mesh", mesh)):
            p = params()
            if m is not None:
                p = distribute_tree(p, lm_param_shardings(cfg, m))
            state = {"params": p, "opt": adamw.init_state(p)}
            step = make_train_step(lm, m, adamw.AdamWConfig(
                lr=1e-2, warmup_steps=0, total_steps=10))
            mets, ms = [], []
            for batch in batches:
                (state, met), t = timed(lambda: step(state, batch))
                mets.append(met)
                ms.append(t)
            train[name] = (mets, tree_leaves(state["params"]), ms)
        row["train_metric_diff"] = max(
            _equal(a[k], b[k]) for a, b in zip(train["none"][0],
                                               train["mesh"][0])
            for k in ("loss", "grad_norm"))
        row["train_param_diff"] = max(_equal(a, b) for a, b in zip(
            train["none"][1], train["mesh"][1]))
        row["train_ms"] = {k: v[2] for k, v in train.items()}
        out[arch] = row
        print(arch, json.dumps(row), flush=True)
    dist.destroy_process_group()
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-gloo", action="store_true")
    ap.add_argument("--skip-one", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="(b) on the CPU over gloo: a rehearsal, no timing "
                    "of the card")
    args = ap.parse_args()
    import torch
    if args.cpu:
        print(json.dumps(probe_one_card("cpu")))
        return 0
    if not torch.cuda.is_available():
        print("probe_mesh: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    res = {"card": card, "torch": torch.__version__}
    if not args.skip_gloo:
        res["gloo_four_ranks_one_card"] = probe_gloo()
        print("gloo:", json.dumps(res["gloo_four_ranks_one_card"]),
              flush=True)
    if not args.skip_one:
        res["one_card_mesh"] = probe_one_card()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
