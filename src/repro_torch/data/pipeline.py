"""Data pipelines: deterministic synthetic LM stream + reservoir tasks.

The LM stream is a stateless function of (seed, step, shard) so any worker
can reproduce any batch — the property that makes checkpoint-resume and
elastic re-sharding exact: no data iterator state needs saving, and a
re-planned mesh re-slices the same global batch ids.

The port's own copy of the JAX package's module (NumPy only), kept line
for line so the same arguments give the same arrays bit for bit.  Arrays
stay NumPy (``lm_batch``'s tokens ``int32``); the caller moves a batch to
its device (as ``int64`` token ids for an embedding lookup).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LMStreamConfig", "lm_batch", "mackey_glass", "narma10",
           "channel_equalization", "memory_capacity_task"]


@dataclasses.dataclass(frozen=True)
class LMStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-ish synthetic text: token_{t+1} = f(token_t) + noise, so models
    # can actually reduce loss below ln(V) (pure uniform noise cannot).
    structure: float = 0.8


def lm_batch(cfg: LMStreamConfig, step: int, shard: int = 0,
             n_shards: int = 1) -> dict:
    """Batch for ``step``; ``shard``/``n_shards`` slice the global batch."""
    assert cfg.global_batch % n_shards == 0
    per = cfg.global_batch // n_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))
    b, s, v = per, cfg.seq_len, cfg.vocab_size
    toks = np.empty((b, s + 1), np.int32)
    toks[:, 0] = rng.integers(0, v, b)
    mult = 6364136223846793005 % v
    structured = rng.random((b, s)) < cfg.structure
    noise = rng.integers(0, v, (b, s))
    for t in range(s):
        nxt = (toks[:, t].astype(np.int64) * mult + 12345) % v
        toks[:, t + 1] = np.where(structured[:, t], nxt, noise[:, t])
    return {"tokens": toks}


# ---------------------------------------------------------------------------
# Reservoir-computing tasks (paper Sec. II workloads)
# ---------------------------------------------------------------------------
def mackey_glass(n: int, tau: int = 17, seed: int = 0, beta=0.2, gamma=0.1,
                 p=10.0, dt=1.0, washout: int = 500) -> np.ndarray:
    """Mackey-Glass delay differential equation (RK4), the canonical ESN
    chaotic-series benchmark."""
    rng = np.random.default_rng(seed)
    hist = 1.2 + 0.2 * (rng.random(tau + 1) - 0.5)
    x = list(hist)

    def f(xt, xd):
        return beta * xd / (1.0 + xd ** p) - gamma * xt

    for _ in range(n + washout):
        xt, xd = x[-1], x[-1 - tau]
        k1 = f(xt, xd)
        k2 = f(xt + 0.5 * dt * k1, xd)
        k3 = f(xt + 0.5 * dt * k2, xd)
        k4 = f(xt + dt * k3, xd)
        x.append(xt + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4))
    return np.asarray(x[tau + 1 + washout:], np.float32)


def narma10(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """NARMA-10 nonlinear autoregressive benchmark: (input u, target y)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 0.5, n + 10).astype(np.float32)
    y = np.zeros(n + 10, np.float32)
    for t in range(9, n + 9):
        y[t + 1] = (0.3 * y[t] + 0.05 * y[t] * y[t - 9:t + 1].sum()
                    + 1.5 * u[t - 9] * u[t] + 0.1)
    return u[10:], y[10:]


def channel_equalization(n: int, seed: int = 0, snr_db: float = 28.0
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Nonlinear channel equalization (paper [3]'s online-learning task).

    A 4-PAM symbol stream d(t) passes through a linear multipath filter and
    a memoryless nonlinearity plus noise; the task is to recover d(t - 2).
    """
    rng = np.random.default_rng(seed)
    pad = 10
    d = rng.choice([-3.0, -1.0, 1.0, 3.0], size=n + 2 * pad).astype(np.float32)
    # Jaeger's nonlinear channel (the formulation [3] equalizes):
    #   q(t) = 0.08 d(t+2) - 0.12 d(t+1) + d(t) + 0.18 d(t-1) - 0.1 d(t-2)
    #          + 0.09 d(t-3) - 0.05 d(t-4) + 0.04 d(t-5) + 0.03 d(t-6)
    #          + 0.01 d(t-7)
    #   u(t) = q + 0.036 q^2 - 0.011 q^3 + noise;  recover d(t) from u.
    taps = [(2, 0.08), (1, -0.12), (0, 1.0), (-1, 0.18), (-2, -0.1),
            (-3, 0.09), (-4, -0.05), (-5, 0.04), (-6, 0.03), (-7, 0.01)]
    idx = np.arange(pad, pad + n)
    q = sum(c * d[idx + k] for k, c in taps)
    q = q + 0.036 * q ** 2 - 0.011 * q ** 3
    sigma = np.sqrt(np.mean(q ** 2) / (10 ** (snr_db / 10)))
    u = (q + rng.normal(0, sigma, q.shape)).astype(np.float32)
    return u, d[idx]


def memory_capacity_task(n: int, max_delay: int = 40, seed: int = 0
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Inputs u(t) ~ U(-1,1); targets y_k(t) = u(t-k) for k=1..max_delay."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1, 1, n + max_delay).astype(np.float32)
    ys = np.stack([u[max_delay - k: n + max_delay - k]
                   for k in range(1, max_delay + 1)], axis=1)
    return u[max_delay:], ys
