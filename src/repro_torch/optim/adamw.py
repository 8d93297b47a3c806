"""AdamW with global-norm clipping and schedules -- hand-rolled, tree-native.

The JAX package's optimizer on nested dicts of tensors, with its exact
update (not ``torch.optim.AdamW``, which decays the parameter before the
step and folds the bias correction into the step size, so it rounds
otherwise):

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
    p = p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p)

in float32 (``bc = 1 - b ** step``), the new parameter cast back to its
dtype.  ``step`` is a 0-dim int32 tensor on the parameters' device and
the schedule runs on it in float32, so a step never waits on the host.
``global_norm`` sums the per-leaf squares in the reference's leaf order
(dict keys sorted, as ``jax.tree.leaves`` walks them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.common import tree_leaves_with_path, tree_map

__all__ = ["AdamWConfig", "schedule", "init_state", "global_norm",
           "clip_by_global_norm", "apply_updates"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay to min_lr_ratio."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params: Any, dtype=torch.float32) -> dict:
    """Zeroed moments like ``params`` (in ``dtype``) and step 0, on the
    parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    leaves = tree_leaves_with_path(params)
    dev = leaves[0][1].device if leaves else None
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float()))
              for _, x in tree_leaves_with_path(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Any, max_norm: float):
    norm = global_norm(grads)
    # a tensor numerator: PyTorch's ``float / tensor`` is a reciprocal
    # times the float (two roundings), not a division
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def apply_updates(params: Any, grads: Any, opt: dict, cfg: AdamWConfig):
    """One AdamW step. Returns (new_params, new_opt, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = opt["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay \
            * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, opt["m"], opt["v"])
    new_params = tree_map(lambda t: t[0], out)
    new_m = tree_map(lambda t: t[1], out)
    new_v = tree_map(lambda t: t[2], out)
    return new_params, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
