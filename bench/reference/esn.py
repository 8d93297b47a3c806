"""Plain reference of a served echo state network (paper Eq. 1 and 2).

    x(n) = (1 - leak) * x(n-1) + leak * tanh(u(n) W_in + x(n-1) W)
    y(n) = x(n) W_out

It works out again everything the program derives from the dense matrix
the benchmark made: the symmetric per-matrix quantization of the weights
to ``weight_bits`` signed integers, and in the int8 modes the per-step
requantization of the states to ``state_bits`` (round half to even).  The
digit planes and culled blocks are exact rewrites of the quantized matrix,
so the integer product ``xq q`` stands for all of them.

``precision`` says how the arithmetic is done:

* ``"float64"``: the configuration's own precision, worked out in
  float64: an fp32 configuration throughout, an int8 configuration with
  the recurrent integer product ``xq q`` exact and everything around it
  (input projection, scale, ``tanh``, leak, readout) in float64.  It
  follows no rounding order of the program's: where the program's float32
  puts a state on the other side of a rounding boundary, the int8 answers
  part by a step of quantization noise, which the limit allows for.
* ``"int4"``: the control of an int8 configuration: weights and states at
  4 bits, the rest as in ``"float64"``.
* ``"tf32"``: the control of an fp32 configuration: every product's
  operands rounded to TF32 (10 mantissa bits), float32 sums.

Plain PyTorch on any device; nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PRECISIONS", "quantize", "rollout", "to_tf32"]

PRECISIONS = ("float64", "int4", "tf32")
ROWS = 256          # sequences rolled together: the check's whole sample


def quantize(dense: np.ndarray, bits: int) -> tuple[np.ndarray, float]:
    """Symmetric per-matrix quantization: ``dense ~ q * scale`` with
    ``q`` in ``[-2**(bits-1), 2**(bits-1) - 1]``."""
    dense = np.asarray(dense, np.float64)
    qmax = (1 << (bits - 1)) - 1
    amax = float(np.abs(dense).max())
    scale = amax / qmax if amax > 0 else 1.0
    q = np.clip(np.round(dense / scale), -qmax - 1, qmax)
    return q, scale


def to_tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (nearest, ties to even mantissa)."""
    b = a.to(torch.float32).contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return ((b + 0xFFF + lsb) & -8192).view(torch.float32)


def _recurrent(spec: dict, dense: np.ndarray, precision: str, device):
    """The recurrent step ``x -> x W`` in the precision asked for, and the
    dtype the states are carried in."""
    int8 = spec["mode"].startswith("int8")
    wbits = 4 if precision == "int4" else spec["weight_bits"]
    q, scale = quantize(dense, wbits)
    if int8:
        sbits = 4 if precision == "int4" else spec["state_bits"]
        smax = (1 << (sbits - 1)) - 1
        qd = torch.as_tensor(q, dtype=torch.float64, device=device)
        rs = scale / smax

        def recur(x):
            xq = torch.clamp(torch.round(x * smax), -smax - 1, smax)
            # every partial sum is an integer below 2**53: exact
            return (xq @ qd) * rs
        return recur, torch.float64
    # fp32 configurations serve the dequantized weights in float32
    w32 = torch.as_tensor((q * scale).astype(np.float32), device=device)
    if precision == "tf32":
        wt = to_tf32(w32)
        return (lambda x: to_tf32(x) @ wt), torch.float32
    wd = w32.to(torch.float64)
    return (lambda x: x @ wd), torch.float64


def rollout(spec: dict, dense: np.ndarray, w_in: np.ndarray,
            w_out: np.ndarray, inputs: list, *, precision: str = "float64",
            device="cpu") -> list:
    """Predictions ``(T_k, O)`` for each ``(T_k, I)`` input sequence in
    ``inputs``, each from the zero state.

    ``spec`` holds the configuration's ``mode``, ``weight_bits``,
    ``state_bits`` and ``leak``.  Sequences run ``ROWS`` at a time, the
    longest first, each block to its longest sequence (the recurrence is
    causal, so a shorter row's padded tail never reaches its answers).
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    recur, fdt = _recurrent(spec, dense, precision, device)
    leak = float(spec["leak"])
    win = torch.as_tensor(np.asarray(w_in, np.float32), device=device)
    wout = torch.as_tensor(np.asarray(w_out, np.float32), device=device)
    if precision == "tf32":
        win, wout = to_tf32(win), to_tf32(wout)
    win = win.to(fdt)
    wout = wout.to(torch.float32 if precision == "tf32" else torch.float64)
    dim = wout.shape[0]
    order = sorted(range(len(inputs)), key=lambda k: -len(inputs[k]))
    out: list = [None] * len(inputs)
    for lo in range(0, len(order), ROWS):
        idx = order[lo:lo + ROWS]
        t_max = len(inputs[idx[0]])
        u = np.zeros((len(idx), t_max, win.shape[0]), np.float32)
        for r, k in enumerate(idx):
            u[r, :len(inputs[k])] = inputs[k]
        ud = torch.as_tensor(u, device=device)
        if precision == "tf32":
            ud = to_tf32(ud)
        ud = ud.to(fdt)
        x = torch.zeros((len(idx), dim), dtype=fdt, device=device)
        ys = torch.empty((t_max, len(idx), wout.shape[1]), dtype=wout.dtype,
                         device=device)
        for t in range(t_max):
            # u(n) W_in input by input, in ascending order
            up = ud[:, t, 0:1] * win[0]
            for i in range(1, win.shape[0]):
                up = up + ud[:, t, i:i + 1] * win[i]
            x = (1.0 - leak) * x + leak * torch.tanh(up + recur(x))
            xo = to_tf32(x) if precision == "tf32" else x.to(wout.dtype)
            ys[t] = xo @ wout
        ys = ys.transpose(0, 1).to(torch.float64).cpu().numpy()
        for r, k in enumerate(idx):
            out[k] = ys[r, :len(inputs[k])]
    return out
