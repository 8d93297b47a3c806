"""End-to-end LM training script on the PyTorch/CUDA port: config -> mesh
-> steps -> checkpoints.

The twin of ``examples/train_lm.py`` on ``repro_torch``.  Exercises the
full production path on the card: deterministic data stream, the train
step with the same sharding rules the 512-chip dry run uses, async
checkpointing with auto-resume, straggler watchdog, and an optional
simulated host failure that goes through the elastic re-plan +
checkpoint-restore path.

Presets:
  tiny  (~11M params, default)  - a few hundred steps in minutes
  100m  (~124M params)          - the assignment's ~100M model; same code,
                                  run with --steps 300 on real hardware

Departures from the reference script: ``--device`` (default ``cuda``;
``--device cpu`` runs on the CPU); weights from a seeded
``torch.Generator`` where the reference takes ``PRNGKey(0)``; the mesh of
``make_host_mesh()`` (``(1, 1)`` with one visible card) runs over a
process group, so the script opens one of one rank (``one_rank_group``:
NCCL on the card, gloo on the CPU) when none is open, and closes it
before it returns; the train state is placed on that mesh and a
checkpoint is restored onto it; the step is called directly (no ``jit``,
the state updated in place for its ``donate_argnums``); ``--ckpt-dir``
defaults to ``build/repro_torch_lm_ckpt`` under the working directory,
so that the twin never resumes a run of the reference; and a closing
``OK`` line when the run is too short for the loss check.

A run resumes from the latest checkpoint in its ``--ckpt-dir``, and a
checkpoint of another preset does not restore (its shapes differ): give
each run below a directory of its own, and delete it for a fresh run.

Run:  python examples/train_lm_torch.py --steps 60 --ckpt-dir build/ckpt_tiny
      python examples/train_lm_torch.py --preset 100m --steps 4 --ckpt-dir build/ckpt_100m
      python examples/train_lm_torch.py --simulate-failure --ckpt-dir build/ckpt_failure
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import LMStreamConfig, lm_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, one_rank_group
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import LM, lm_param_shardings
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import distribute_tree
from repro_torch.runtime.elastic import StragglerWatchdog, replan_after_failure

PRESETS = {
    "tiny": ModelConfig(
        name="tiny-lm", family="dense", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=2048,
        tie_embeddings=True, remat="none"),
    "100m": ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=32768,
        tie_embeddings=True, remat="full"),
}


def _local(x):
    """A step's output as a plain tensor (on a mesh of one rank a DTensor's
    shard is the whole tensor)."""
    return x.to_local() if hasattr(x, "to_local") else x


def state_shardings(cfg, mesh):
    """Where each leaf of the train state lives on ``mesh``: the moments
    beside their parameters, the step count a plain tensor."""
    params = lm_param_shardings(cfg, mesh)
    return {"params": params,
            "opt": {"m": params, "v": params, "step": None}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="build/repro_torch_lm_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--simulate-failure", action="store_true",
                    help="kill-and-recover mid-run through the elastic path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    dev = resolve_device(args.device)
    with one_rank_group(dev):
        lm = LM(cfg, device=dev)
        mesh = make_host_mesh(dev)
        print(f"preset={args.preset} params={lm.param_count():,} "
              f"devices={mesh.size}")
        losses, start, wd = train(lm, mesh, args)

    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    print(f"\nloss {first:.3f} -> {last:.3f} over {len(losses)} steps "
          f"(stragglers flagged: {len(wd.flagged)})")
    if len(losses) >= 40:
        assert last < first - 0.3, "training did not reduce loss"
        print("OK: loss decreased")
    else:
        print("OK")
    return {"losses": losses, "start": start, "step_s": wd.durations}


def train(lm, mesh, args, params=None):
    """The training loop on ``mesh`` from ``params`` (by default the seeded
    initial weights): (losses, the first step it ran, the straggler
    watchdog, which holds each step's seconds and the steps it flagged)."""
    cfg, dev = lm.cfg, lm.device
    stream = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                            global_batch=args.batch, seed=0)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20,
                                total_steps=max(args.steps, 100))

    shardings = state_shardings(cfg, mesh)
    if params is None:
        params = lm.init(torch.Generator(device=dev).manual_seed(0)).params
    params = distribute_tree(params, shardings["params"])
    opt = adamw.init_state(params)
    state = {"params": params, "opt": opt}

    start = 0
    resumed = store.latest_step(args.ckpt_dir)
    if resumed is not None:
        state = store.restore(state, args.ckpt_dir, resumed,
                              shardings=shardings)
        start = resumed + 1
        print(f"resumed from checkpoint step {resumed}")

    step_fn = make_train_step(lm, mesh, opt_cfg)
    ck = store.Checkpointer(args.ckpt_dir, every=args.ckpt_every, keep=2)
    wd = StragglerWatchdog(threshold=4.0)

    losses = []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                 for k, v in lm_batch(stream, step).items()}
        state, metrics = step_fn(state, batch)
        loss = float(_local(metrics["loss"]))     # waits for the step
        wd.record(step, time.perf_counter() - t0)
        losses.append(loss)
        ck.maybe_save(state, step)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {loss:7.4f} "
                  f"lr {float(_local(metrics['lr'])):.2e} "
                  f"gnorm {float(_local(metrics['grad_norm'])):.2f} "
                  f"({time.perf_counter() - t0:.2f}s)")

        if args.simulate_failure and step == args.steps // 2:
            print("\n--- simulating host failure: 16 of 256 devices lost ---")
            plan = replan_after_failure(256, failed=16, model_parallel=16)
            for action in plan["actions"]:
                print("   ", action)
            print(f"    new mesh: {plan['mesh_shape']} {plan['mesh_axes']}")
            ck.finalize()
            resumed = store.latest_step(args.ckpt_dir)
            assert resumed is not None, "no verified checkpoint to resume!"
            state = store.restore(state, args.ckpt_dir, resumed,
                                  shardings=shardings)
            print(f"    restored verified checkpoint step {resumed}; "
                  f"resuming\n")

    ck.finalize()
    return losses, start, wd


if __name__ == "__main__":
    main()
