"""Echo State Networks (reservoir computing) — paper Section II.

    x(n) = (1 - leak) * x(n-1) + leak * f(W_in u(n) + W x(n-1))      (Eq. 1)
    y(n) = W_out x(n)                                                 (Eq. 2)

W and W_in are random, sparse and *fixed*; only W_out is trained (ridge).
The recurrent multiply ``W x`` is the primitive the whole paper accelerates;
here it runs through :class:`repro_torch.core.sparse.FixedMatrix`, so the
same offline-compiled structure backs the float reference path, the
exact-integer digit-plane path (paper [16]-style integer ESN), and the CUDA
rollout kernels.

Rollouts dispatch to the batched engine in :mod:`repro_torch.serve.engine`
by default; pass ``engine="scan"`` for the plain per-step loop baseline.

Reservoir construction follows the standard echo-state heuristics the paper
cites: Bernoulli element sparsity ([5] uses 75%, [10] recommends >80%),
spectral-radius rescaling below 1, and uniform input weights.  The matrix
and input weights come from a seeded numpy generator, drawn in the same
order as the JAX package draws them, so both give the same weights.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch.core import bitplanes as bp
from repro_torch.core import ridge
from repro_torch.core.sparse import FixedMatrix, random_sparse_matrix
from repro_torch.device import resolve_device

__all__ = ["ESNConfig", "ESNParams", "init_esn", "params_from_numpy",
           "run_reservoir", "run_readout", "fit_readout", "predict", "nrmse"]


@dataclasses.dataclass(frozen=True)
class ESNConfig:
    reservoir_dim: int = 800            # [5]'s baseline reservoir: dim 800
    input_dim: int = 1
    output_dim: int = 1
    element_sparsity: float = 0.75      # [5]: "75% of the elements being 0"
    spectral_radius: float = 0.9
    input_scale: float = 0.5
    leak: float = 1.0
    weight_bits: int = 8                # paper: 8-bit signed weights
    state_bits: int = 8                 # [16]: 3-4 bits lose no accuracy
    mode: Literal["fp32", "int8-pn", "int8-csd"] = "fp32"
    block: int = 128
    seed: int = 0

    @property
    def digit_mode(self) -> str:
        return "csd" if self.mode == "int8-csd" else "pn"


@dataclasses.dataclass
class ESNParams:
    w: FixedMatrix                      # reservoir matrix, compiled offline
    w_in: torch.Tensor                  # (input_dim, reservoir_dim) float32
    w_out: torch.Tensor | None          # (reservoir_dim, output_dim)
    config: ESNConfig

    @property
    def device(self) -> torch.device:
        return self.w_in.device


def _spectral_rescale(m: np.ndarray, target: float,
                      seed: int) -> np.ndarray:
    """Scale so the spectral radius equals ``target``.

    Random reservoirs have complex dominant eigenvalues (circular law), so a
    real power iteration underestimates rho badly; use ARPACK (complex) with
    a dense-eig fallback for small matrices.

    Unlike the JAX package, ARPACK starts from a vector drawn from its own
    generator seeded with ``seed``, and keeps up to 64 Lanczos vectors: with
    ARPACK's random start and its default 20 vectors, a dim-1024 reservoir
    whose top moduli lie within 1 % of each other sometimes converged to a
    smaller eigenvalue, so one seed gave different weights in each process.
    """
    n = m.shape[0]
    rho = 0.0
    try:
        import scipy.sparse.linalg as sla
        v0 = np.random.default_rng(seed).uniform(-1.0, 1.0, n)
        vals = sla.eigs(m.astype(np.float64), k=1, which="LM",
                        return_eigenvectors=False, maxiter=n * 20, v0=v0,
                        ncv=min(64, n))
        rho = float(np.abs(vals[0]))
    except (ImportError, ArithmeticError, RuntimeError):
        pass
    if not np.isfinite(rho) or rho <= 0:
        rho = float(np.abs(np.linalg.eigvals(m)).max())
    return m * (target / max(rho, 1e-12))


def init_esn(cfg: ESNConfig, *, device=None) -> ESNParams:
    """Random reservoir for ``cfg`` on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    w_dense = random_sparse_matrix(cfg.reservoir_dim, cfg.reservoir_dim,
                                   cfg.element_sparsity, rng)
    w_dense = _spectral_rescale(w_dense, cfg.spectral_radius, cfg.seed)
    w = FixedMatrix.compile(w_dense, weight_bits=cfg.weight_bits,
                            mode=cfg.digit_mode, block=cfg.block, rng=rng)
    w_in = rng.uniform(-cfg.input_scale, cfg.input_scale,
                       size=(cfg.input_dim, cfg.reservoir_dim))
    return ESNParams(w=w, w_in=torch.as_tensor(w_in, dtype=torch.float32,
                                               device=dev),
                     w_out=None, config=cfg)


def params_from_numpy(*, q, scale, pos, neg, block_mask, w_in, w_out,
                      config: ESNConfig, device=None) -> ESNParams:
    """Carry weights compiled elsewhere into the port, bit for bit.

    ``q`` (quantized weights), ``scale``, the ``pos``/``neg`` digit planes
    and ``block_mask`` are the offline compile's artefacts as numpy arrays
    (e.g. read off another implementation's ``FixedMatrix``); no CSD
    decomposition is re-run, so the planes — including CSD's randomized
    length-2 tie-breaks — are exactly the ones given.  ``w_out`` may be
    ``None`` (untrained readout).  Raises if the block structure rebuilt
    from ``q`` disagrees with ``block_mask``.
    """
    dev = resolve_device(device)
    pos = np.asarray(pos, np.uint8)
    neg = np.asarray(neg, np.uint8)
    planes = bp.DigitPlanes(pos=pos, neg=neg, mode=config.digit_mode,
                            source_bits=config.weight_bits)
    if not np.array_equal(planes.to_dense(), np.asarray(q, np.int64)):
        raise ValueError("digit planes do not recompose to q")
    fm = FixedMatrix.from_parts(np.asarray(q), float(scale), planes,
                                config.block)
    if not np.array_equal(fm.blocks.mask, np.asarray(block_mask, bool)):
        raise ValueError("block_mask disagrees with the structure of q")
    as_t = lambda a: torch.tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=dev)
    return ESNParams(w=fm, w_in=as_t(w_in),
                     w_out=None if w_out is None else as_t(w_out),
                     config=config)


def _step_fp32(params: ESNParams, x: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    cfg = params.config
    pre = u @ params.w_in + params.w.matmul(x)
    nxt = torch.tanh(pre)
    return (1.0 - cfg.leak) * x + cfg.leak * nxt


def _step_int8(params: ESNParams, x: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """Integer reservoir update (paper [16]): states quantized each step.

    The recurrent product runs through the exact digit-plane path — the same
    arithmetic the bit-serial FPGA performs — then is rescaled to float for
    the activation.
    """
    cfg = params.config
    smax = (1 << (cfg.state_bits - 1)) - 1
    xq = torch.clamp(torch.round(x * smax), -smax - 1, smax).to(torch.int32)
    recur = params.w.matvec_int_exact(xq).to(torch.float32)
    recur = recur * (params.w.scale / smax)
    pre = u @ params.w_in + recur
    nxt = torch.tanh(pre)
    return (1.0 - cfg.leak) * x + cfg.leak * nxt


def _run_reservoir_scan(params: ESNParams, inputs: torch.Tensor,
                        x0: torch.Tensor | None = None) -> torch.Tensor:
    """Plain per-step rollout (the baseline): (T, I) or (B, T, I)."""
    cfg = params.config
    step = _step_int8 if cfg.mode.startswith("int8") else _step_fp32
    u = torch.as_tensor(inputs, dtype=torch.float32, device=params.device)
    single = u.ndim == 2
    if single:
        u = u[None]
    b = u.shape[0]
    x = (torch.zeros((b, cfg.reservoir_dim), device=u.device)
         if x0 is None else torch.as_tensor(x0, dtype=torch.float32,
                                            device=u.device).expand(
                                                b, cfg.reservoir_dim))
    states = []
    for t in range(u.shape[1]):
        x = step(params, x, u[:, t])
        states.append(x)
    out = torch.stack(states, dim=1)
    return out[0] if single else out


def run_reservoir(params: ESNParams, inputs, x0=None,
                  engine: str = "auto") -> torch.Tensor:
    """Roll the reservoir over ``inputs`` (T, input_dim) -> states (T, dim).

    Batched inputs (B, T, input_dim) return (B, T, dim) states.

    ``engine`` picks the rollout implementation:
      * "auto" — the batched engine in :mod:`repro_torch.serve.engine`
        (the CUDA rollout kernels; their plain PyTorch twins when the
        params live on the CPU).
      * "scan" — the plain per-step loop (baseline).
    """
    if engine == "scan":
        return _run_reservoir_scan(params, inputs, x0)
    if engine != "auto":
        raise ValueError(f"unknown engine {engine!r}; expected 'auto' or "
                         "'scan'")
    from repro_torch.serve.engine import engine_for  # serve imports esn
    return engine_for(params, backend=engine).rollout(inputs, x0)


def run_readout(params: ESNParams, inputs, x0=None,
                engine: str = "auto") -> torch.Tensor:
    """Roll the reservoir AND apply the trained readout in one pass.

    (T, input_dim) -> (T, output_dim) predictions (batched inputs return
    (B, T, output_dim)).  ``W_out`` is applied by the rollout's readout
    kernel after each step, so the state trajectory is never materialized
    — the serving path ("serving returns predictions, not states").
    """
    if params.w_out is None:
        raise ValueError("readout not trained; call fit_readout first")
    if engine == "scan":
        return predict(params, _run_reservoir_scan(params, inputs, x0))
    if engine != "auto":
        raise ValueError(f"unknown engine {engine!r}; expected 'auto' or "
                         "'scan'")
    from repro_torch.serve.engine import engine_for  # serve imports esn
    return engine_for(params, backend=engine).predictions(inputs, x0)


def fit_readout(params: ESNParams, states: torch.Tensor,
                targets: torch.Tensor, lam: float = 1e-6,
                washout: int = 0) -> ESNParams:
    """Ridge-fit ``W_out`` on (T, R) or batched (B, T, R) state trajectories.

    ``washout`` discards the initial transient of *each* sequence: for
    batched states the first ``washout`` steps are dropped per sequence
    (along the time axis) before flattening.
    """
    states = torch.as_tensor(states, device=params.device)
    targets = torch.as_tensor(targets, dtype=torch.float32,
                              device=params.device)
    if washout:
        states = states[..., washout:, :]
        targets = targets[..., washout:, :]
    s = states.reshape(-1, states.shape[-1])
    t = targets.reshape(-1, targets.shape[-1])
    w_out = ridge.ridge_fit(s, t, lam)
    return dataclasses.replace(params, w_out=w_out)


def predict(params: ESNParams, states: torch.Tensor) -> torch.Tensor:
    if params.w_out is None:
        raise ValueError("readout not trained; call fit_readout first")
    return states @ params.w_out


def nrmse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    err = torch.mean((pred - target) ** 2)
    var = torch.var(target, unbiased=False) + 1e-12
    return torch.sqrt(err / var)
