#!/usr/bin/env python3
"""Where a decode step of the LM serving path spends its time on the card.

Run from the root of a checkout::

    python3 tools/probe_lm_decode.py [--arch NAME] [--batch B] [--prompt S]

It builds the config at full width in bf16 from a seeded generator on the
card (mistral-nemo-12b by default; any registered config, the MoE, MLA,
recurrent and enc-dec ones included), prefills ``B`` random prompts of ``S``
tokens, then for the bf16 tree and for its ``quantize_tree`` int8 tree
times one decode step (with its greedy argmax) three ways: the host's
enqueue time (the call returns before the device is done), the wall time
to a device sync, and a ``torch.profiler`` profile of two steps (kernels
launched per step, device time per step, the heaviest kernels).  Device
busy share = device time / wall time.  Last, one more profile of a single
small kernel, since on the chip machine a profile taken after profiles of
thousands of launches has come back empty (``PERF.md`` §7): it prints
how many launches that profile saw.  One JSON line at the end carries the
numbers and the card's name and power limit.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def profile(torch, fn, n):
    """(kernels per call, device ms per call, kernel rows) over n calls."""
    from torch.profiler import ProfilerActivity, profile as prof
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in p.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in rows) / n,
            sum(e.device_time_total for e in rows) / n / 1e3, rows)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_lm_decode: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models.quantize import quantize_tree
    from repro_torch.models.transformer import LM
    name = card()
    cfg = get_config(args.arch)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=lm.device).manual_seed(0)).params
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                         device=lm.device)
    batch = {"tokens": toks}
    if cfg.encoder is not None:      # whisper: stub frame embeddings
        batch["frames"] = torch.randn(
            (args.batch, cfg.encoder.seq_len, cfg.d_model), device=lm.device)
    result = {"arch": args.arch, "batch": args.batch, "prompt": args.prompt,
              "card": name}
    for tag in ("bf16", "int8"):
        tree = params if tag == "bf16" else quantize_tree(params)
        logits, caches = lm.prefill(tree, batch,
                                    cache_len=args.prompt + 16)
        state = {"caches": caches, "tok": logits.argmax(-1)}

        def step():
            lg, state["caches"] = lm.decode_step(tree, state["caches"],
                                                 state["tok"])
            state["tok"] = lg.argmax(-1)

        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        kernels, dev_ms, rows = profile(torch, step, 2)
        wall = (t2 - t0) * 1e3
        result[tag] = dict(enqueue_ms=(t1 - t0) * 1e3, wall_ms=wall,
                           kernels_per_step=kernels, device_ms=dev_ms,
                           device_busy=dev_ms / wall)
        print(f"{tag} decode step at {args.batch} x {args.prompt}: host "
              f"enqueue {(t1 - t0) * 1e3:.2f} ms, wall {wall:.2f} ms, "
              f"{kernels:.0f} kernels, {dev_ms:.3f} ms device time "
              f"({dev_ms / wall:.0%} busy) on {name}")
        for e in sorted(rows, key=lambda e: -e.device_time_total)[:10]:
            print(f"   {e.key[:72]}: {e.count / 2:.0f} per step, "
                  f"{e.device_time_total / 2 / 1e3:.3f} ms")
        del tree, logits, caches, state
    x = torch.ones(1024, device=lm.device)
    after = profile(torch, lambda: x.add_(1), 1)[0]
    result["launches_seen_by_a_later_profile"] = after
    print(f"a later profile of one small kernel saw {after:.0f} launches")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
