"""How ``correct`` is decided: the timed path's answers against the plain
reference.

Every request due in the window must have been answered, with one
prediction per input step.  A sample of the answered requests, drawn from
the seed and always holding the longest, is run through the reference
(``bench/reference``) on the same inputs and weights, and the widest gap
between a served prediction and the reference's is compared, as a share
of the reference's RMS prediction over the sample (``pred_err``).  The
limits are the configuration's (``"limits"`` in its file).

The control (:func:`control_numbers`) puts the reference, computed one
precision below the configuration's, in the program's place.
"""

from __future__ import annotations

import numpy as np

from bench.gen import seed_words
from bench.reference import esn as reference

__all__ = ["SAMPLE", "control_precision", "sample_keys", "compare",
           "check_window", "control_numbers"]

SAMPLE = 256


def control_precision(mode: str) -> str:
    """The precision one step below what a configuration states: int4 for
    int8 weights and states, TF32 for fp32 with TF32 off."""
    return "int4" if mode.startswith("int8") else "tf32"


def sample_keys(window, seed: int) -> list:
    """The answered requests to compare: ``SAMPLE - 1`` drawn from the
    seed, and the longest answered one."""
    keys = sorted(window.done)
    if not keys:
        return []
    longest = max(keys, key=lambda k: (window.lengths[k], -k))
    rest = [k for k in keys if k != longest]
    rng = np.random.default_rng(seed_words(seed, "sample"))
    pick = rng.choice(len(rest), min(SAMPLE - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def compare(answers: list, refs: list) -> tuple[float, list]:
    """``pred_err`` over the sample and each request's own widest gap on
    the same scale."""
    sq = sum(float(np.sum(np.square(r))) for r in refs)
    n = sum(r.size for r in refs)
    rms = (sq / max(n, 1)) ** 0.5 or 1.0
    gaps = [float(np.max(np.abs(np.asarray(a, np.float64) - r))) / rms
            if r.size else 0.0 for a, r in zip(answers, refs)]
    return max(gaps, default=0.0), gaps


def _spec(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("mode", "weight_bits", "state_bits", "leak")}


def check_window(cfg: dict, weights, traffic, window, seed: int, device
                 ) -> dict:
    """The compared numbers (each ``{"value", "limit"}``), ``failed`` (due
    requests never answered, answered in the wrong shape, or sampled and
    over the limit) and the sample's keys."""
    limit = float(cfg["limits"]["pred_err"])
    o = cfg["output_dim"]
    bad = [k for k in window.due
           if k not in window.answers
           or tuple(np.shape(window.answers[k])) != (window.lengths[k], o)]
    keys = [k for k in sample_keys(window, seed) if k not in bad]
    refs = reference.rollout(_spec(cfg), weights.dense, weights.w_in,
                             weights.w_out, [traffic.inputs(k) for k in keys],
                             device=device)
    err, gaps = compare([window.answers[k] for k in keys], refs)
    over = sum(g > limit for g in gaps)
    return {"numbers": {"unanswered": {"value": len(bad), "limit": 0},
                        "pred_err": {"value": err, "limit": limit}},
            "failed": len(bad) + over, "keys": keys, "refs": refs}


def control_numbers(cfg: dict, weights, traffic, keys: list, refs: list,
                    device) -> float:
    """``pred_err`` of the control in the program's place, on the same
    sampled requests."""
    ctrl = reference.rollout(_spec(cfg), weights.dense, weights.w_in,
                             weights.w_out, [traffic.inputs(k) for k in keys],
                             precision=control_precision(cfg["mode"]),
                             device=device)
    return compare(ctrl, refs)[0]
