#!/usr/bin/env python3
"""How stablelm-1.6b's training loss moves over 40 steps at several
learning rates and warmups, on the card.

Run from the root of a checkout::

    python3 tools/probe_lm_train.py LR:WARMUP [LR:WARMUP ...]

e.g. ``3e-3:20 3e-4:0 2e-4:0``.  For each pair it draws stablelm-1.6b's
parameters at full width in bf16 from the same seeded generator on the
card, then takes the 40 steps of ``chip_smoke.py``'s ``train`` phase
(``lm_batch`` at 8 x 2048 tokens, seed 0, structure 0.8; AdamW with the
given lr and warmup, 100 total steps) through ``make_train_step``, and
prints the means of the first and last 5 losses, their difference (the
``examples/train_lm.py`` check wants 0.3) and every fifth loss.  The
train phase's optimizer was chosen from these runs (``PERF.md`` §6).
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(pairs) -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_lm_train: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMStreamConfig, lm_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import LM
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("stablelm-1.6b")
    lm = LM(cfg, device=dev)
    stream = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=2048,
                            global_batch=8, seed=0, structure=0.8)
    batches = [{"tokens": torch.as_tensor(lm_batch(stream, i)["tokens"],
                                          dtype=torch.long, device=dev)}
               for i in range(40)]
    for pair in pairs:
        lr, warm = pair.split(":")
        lr, warm = float(lr), int(warm)
        t0 = time.perf_counter()
        params = lm.init(torch.Generator(device=dev).manual_seed(0)).params
        state = {"params": params, "opt": adamw.init_state(params)}
        step = make_train_step(lm, None, adamw.AdamWConfig(
            lr=lr, warmup_steps=warm, total_steps=100))
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(m["loss"])
        loss = torch.stack(losses).cpu().numpy()
        first, last = loss[:5].mean(), loss[-5:].mean()
        print(f"lr {lr:g} warmup {warm}: first5 {first:.4f} last5 "
              f"{last:.4f} drop {first - last:.4f} every5 "
              f"{[round(float(x), 3) for x in loss[::5]]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del state, params, m
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
