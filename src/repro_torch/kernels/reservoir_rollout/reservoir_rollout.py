"""Fused batched reservoir rollout: the generic banded kernel (B1).

T steps of paper Eq. 1 for a whole state batch:

    x(n) = (1 - leak) * x(n-1) + leak * f(u(n) @ W_in + x(n-1) @ W)
    y(n) = x(n) @ W_out                                       (optional, Eq. 2)

The recurrent reduction is driven by the plan's static per-band term lists
(:meth:`repro_torch.plan.ExecutionPlan.rollout_layout`): culled blocks —
and, in int8 mode, culled digit plane-blocks — never appear, the analogue
of the paper's synthesis-time adder culling.  Two modes share one kernel:

* ``fp32`` — dequantized tiles, summed in ascending row order;
* ``int8`` — exact digit-plane arithmetic: the state batch is requantized
  every step and each term is a shifted int32 plane-tile product.

This module holds what both rollout kernels share — the device descriptor
tables, the host loop over T (one CUDA launch per step), the readout
kernel's wrapper and the plain PyTorch twin of one step — and the B1 entry
point :func:`reservoir_rollout` with its twin
:func:`reservoir_rollout_plain`.  A CUDA tensor goes through the kernel
(``csrc/rollout.cu``) or raises; a CPU tensor takes the twin, the port's
analogue of Pallas ``interpret=True``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.sparse import int_matmul_exact
from repro_torch.kernels._build import check
from repro_torch.kernels._launch import (check_f32, on_cuda, require_cuda,
                                         same_device, stream, unit_stride)
from repro_torch.kernels.reservoir_rollout import _cuda
from repro_torch.plan.specialize import MM

__all__ = ["RolloutTables", "build_tables", "generic_schedules",
           "plain_recurrent_product", "reservoir_rollout",
           "reservoir_rollout_plain",
           "rollout_readout", "rollout_readout_plain"]

_MAX_SLICE = 32               # output columns per thread block
_MAX_THREADS = 1024
_MAX_SMEM = 48 * 1024         # default dynamic shared memory per block


def column_slice(block: int) -> int:
    """Columns of a column block that one thread block owns: the largest
    divisor of ``block`` up to 32."""
    return max(d for d in range(1, min(_MAX_SLICE, block) + 1)
               if block % d == 0)


@dataclasses.dataclass(frozen=True)
class RolloutTables:
    """A rollout schedule lowered into device tables (one per device).

    ``terms`` rows are ``(0, tile, shift, row_block)`` for a tile product
    and ``(1, row_block, digit_lo, digit_hi)`` for a shift-add group whose
    ``(i, j, sign, w)`` digits sit in ``digits[digit_lo:digit_hi]``;
    ``col_ptr[ci]:col_ptr[ci + 1]`` are output column block ``ci``'s terms,
    in schedule order.  ``tiles`` flattens the banded data to
    ``(n_bands * max_terms, block, block)``.
    """

    mode: str
    block: int
    n_col_blocks: int
    tiles: torch.Tensor
    col_ptr: torch.Tensor
    terms: torch.Tensor
    digits: torch.Tensor
    col_ptr_host: tuple
    terms_host: tuple
    n_matmul_terms: int
    n_digits: int

    @property
    def int8(self) -> bool:
        return self.mode == "int8"


def generic_schedules(band_plans: tuple) -> tuple:
    """B1's ``(slot, shift, row_block)`` band plans as MM-tagged terms."""
    return tuple(tuple((ci, tuple((MM, slot, shift, ri)
                                  for slot, shift, ri in terms))
                       for ci, terms in band)
                 for band in band_plans)


def build_tables(schedules: tuple, data: np.ndarray, *, mode: str,
                 n_col_blocks: int, device) -> RolloutTables:
    """Pack MM/SA-tagged band schedules + banded tile data for ``device``."""
    n_bands, max_terms, bk, _ = data.shape
    per_col: list[list[tuple]] = [[] for _ in range(n_col_blocks)]
    digits: list[tuple] = []
    for bi, band in enumerate(schedules):
        for ci, terms in band:
            for term in terms:
                if term[0] == MM:
                    _tag, slot, shift, ri = term
                    per_col[ci].append((0, bi * max_terms + slot, shift, ri))
                else:
                    _tag, ri, dgs = term
                    lo = len(digits)
                    digits.extend(dgs)
                    per_col[ci].append((1, ri, lo, len(digits)))
    col_ptr = np.cumsum([0] + [len(c) for c in per_col]).astype(np.int32)
    rows = [t for col in per_col for t in col]
    as_i32 = lambda a: torch.as_tensor(                      # noqa: E731
        np.asarray(a, np.int32).reshape(-1, 4), device=device)
    return RolloutTables(
        mode=mode, block=bk, n_col_blocks=n_col_blocks,
        tiles=torch.as_tensor(data.reshape(n_bands * max_terms, bk, bk),
                              device=device),
        col_ptr=torch.as_tensor(col_ptr, device=device),
        terms=as_i32(rows or np.zeros((1, 4))),
        digits=as_i32(digits or np.zeros((1, 4))),
        col_ptr_host=tuple(int(c) for c in col_ptr),
        terms_host=tuple(rows),
        n_matmul_terms=sum(1 for r in rows if r[0] == 0),
        n_digits=len(digits))


# -- readout kernel -----------------------------------------------------------
def rollout_readout_plain(x: torch.Tensor, w_out: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of :func:`rollout_readout`: ``x @ w_out``."""
    y = x @ w_out
    if out is None:
        return y
    out.copy_(y)
    return out


def rollout_readout(x: torch.Tensor, w_out: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """``y = x @ W_out`` for a (B, dim) state, by the readout kernel on a
    CUDA tensor (one thread block per row, fixed reduction order) or by
    the twin on a CPU tensor."""
    if not on_cuda(x, w_out, out):
        return rollout_readout_plain(x, w_out, out)
    b, dim = x.shape
    o = w_out.shape[1]
    if out is None:
        out = torch.empty((b, o), device=x.device)
    check_f32(x, w_out, out)
    if (not unit_stride(x, 1) or not unit_stride(out, 1)
            or not w_out.is_contiguous()):
        raise ValueError("rollout_readout needs row-major x, out and w_out")
    if w_out.shape[0] != dim or out.shape != (b, o):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_out "
                         f"{tuple(w_out.shape)}, out {tuple(out.shape)}")
    rc = _cuda.LIBRARY.load().rollout_readout(
        x.data_ptr(), x.stride(0), w_out.data_ptr(), out.data_ptr(),
        out.stride(0), b, dim, o, stream(x.device))
    check(rc, "rollout_readout")
    rollout_readout.launches += 1
    return out


rollout_readout.launches = 0


# -- shared checks ------------------------------------------------------------
def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check_operands(u_seq, tables, w_in, x0, w_out, final_out, b_tile,
                   want_preds, readout_every):
    """Everything a step launch needs of its operands but the device
    type: same device, dtypes, shapes, strides, and a batch tile that fits
    one thread block.  Raises ``ValueError`` / ``TypeError``."""
    dev = u_seq.device
    same_device(dev, tables.tiles, w_in, x0, w_out, final_out)
    check_f32(u_seq, w_in, x0, w_out, final_out)
    want = torch.int8 if tables.int8 else torch.float32
    if tables.tiles.dtype != want:
        raise TypeError(f"{tables.mode} tiles must be {want}, "
                        f"got {tables.tiles.dtype}")
    if u_seq.dim() != 3 or not unit_stride(u_seq, 2):
        raise ValueError("u_seq must be (T, B, I) with unit stride over I")
    t, b, i = u_seq.shape
    if t < 1:
        raise ValueError("u_seq needs at least one step")
    dim = x0.shape[-1]
    bk = tables.block
    if x0.shape != (b, dim) or not x0.is_contiguous():
        raise ValueError(f"x0 must be a contiguous ({b}, dim) tensor, got "
                         f"{tuple(x0.shape)}")
    if not (tables.n_col_blocks - 1) * bk < dim <= tables.n_col_blocks * bk:
        raise ValueError(f"state dim {dim} does not match "
                         f"{tables.n_col_blocks} column blocks of {bk}")
    if w_in.shape != (i, dim) or not w_in.is_contiguous():
        raise ValueError(f"w_in must be a contiguous ({i}, {dim}) tensor")
    if want_preds:
        if w_out is None or w_out.shape[0] != dim:
            raise ValueError("want_preds needs a (dim, O) w_out")
        if t % readout_every:
            raise ValueError(f"readout_every={readout_every} must divide "
                             f"T={t}")
    if final_out is not None and (final_out.shape != (b, dim)
                                  or not final_out.is_contiguous()):
        raise ValueError("final_out must be a contiguous (B, dim) tensor")
    cw = column_slice(bk)
    smem = (b_tile * bk * 4 + (b_tile * cw * 4 if tables.int8 else 0)
            + bk * cw * tables.tiles.element_size())
    if cw * b_tile > _MAX_THREADS or smem > _MAX_SMEM:
        raise ValueError(f"batch tile {b_tile} x block {bk} exceeds one "
                         "thread block; lower batch_tile_max")


def _launch_rollout(entry: str, counted, u_seq, tables, w_in, x0, w_out, *,
                    leak, smax, recur_scale, b_tile, readout_every,
                    want_states, want_preds, want_final, final_out):
    """The host loop over T: one step kernel launch per step (counted on
    ``counted.launches``), plus the readout kernel every
    ``readout_every`` steps.  The state ping-pongs through device buffers
    (or the states output itself); the last step writes straight into the
    final-state buffer — the caller's carry when it donates one."""
    require_cuda(u_seq)
    check_operands(u_seq, tables, w_in, x0, w_out, final_out, b_tile,
                   want_preds, readout_every)
    fn = getattr(_cuda.LIBRARY.load(), entry)
    dev = u_seq.device
    t_steps, b, i = u_seq.shape
    dim = x0.shape[1]
    cuda_stream = stream(dev)
    states = (torch.empty((t_steps, b, dim), device=dev)
              if want_states else None)
    preds = (torch.empty((t_steps // readout_every, b, w_out.shape[1]),
                         device=dev) if want_preds else None)
    final = None
    if want_final:
        final = (final_out if final_out is not None
                 else torch.empty((b, dim), device=dev))
    cur = x0.clone() if (final is x0 and t_steps == 1) else x0
    ping = None
    consts = (b, dim, i, tables.block, column_slice(tables.block),
              tables.n_col_blocks, b_tile, 1.0 - leak, leak, float(smax),
              recur_scale)
    tables_ptrs = (tables.tiles.data_ptr(), tables.col_ptr.data_ptr(),
                   tables.terms.data_ptr(), tables.digits.data_ptr())
    for t in range(t_steps):
        copy = None
        if want_final and t == t_steps - 1:
            nxt = final
            copy = states[t] if want_states else None
        elif want_states:
            nxt = states[t]
        else:
            if ping is None:
                ping = (torch.empty((b, dim), device=dev),
                        torch.empty((b, dim), device=dev))
            nxt = ping[t % 2]
        rc = fn(int(tables.int8), cur.data_ptr(), cur.stride(0),
                nxt.data_ptr(), nxt.stride(0), _ptr(copy),
                0 if copy is None else copy.stride(0),
                u_seq[t].data_ptr(), u_seq.stride(1), w_in.data_ptr(),
                *tables_ptrs, *consts, cuda_stream)
        check(rc, entry)
        counted.launches += 1
        if want_preds and (t + 1) % readout_every == 0:
            rollout_readout(nxt, w_out, out=preds[(t + 1) // readout_every - 1])
        cur = nxt
    obs.event("kernel_launch", kernel=entry, steps=t_steps, batch=b)
    obs.inc("kernel_launches_total", t_steps, kernel=entry)
    return _pack(states, preds, final)


def _pack(states, preds, final):
    out = [o for o in (states, preds, final) if o is not None]
    return out[0] if len(out) == 1 else tuple(out)


# -- plain twin ---------------------------------------------------------------
def plain_recurrent_product(x: torch.Tensor,
                            tables: RolloutTables) -> torch.Tensor:
    """The twin's recurrent product ``x @ W`` over the term tables.

    int8: ``x`` is the (B, rows_pad) int32 quantized state and the result
    the exact int32 product (tile products in float64, exact for int8
    operands; shift-add digits scattered with ``index_add_``).  fp32: the
    (B, rows_pad) float state, each column's tile products summed in
    schedule order (culled columns are zero).
    """
    bk = tables.block
    b = x.shape[0]
    cp, rows = tables.col_ptr_host, tables.terms_host
    out = torch.zeros((b, tables.n_col_blocks * bk), dtype=x.dtype,
                      device=x.device)
    for ci in range(tables.n_col_blocks):
        acc = None
        for kind, a, c, d in rows[cp[ci]:cp[ci + 1]]:
            if kind == 0:
                xs = x[:, d * bk:(d + 1) * bk]
                if tables.int8:
                    contrib = int_matmul_exact(xs, tables.tiles[a]) << c
                else:
                    contrib = xs @ tables.tiles[a]
                acc = contrib if acc is None else acc + contrib
            else:
                if acc is None:
                    acc = torch.zeros((b, bk), dtype=x.dtype,
                                      device=x.device)
                dg = tables.digits[c:d].long()
                col = torch.bitwise_left_shift(x[:, a * bk + dg[:, 0]],
                                               dg[:, 3].int())
                acc.index_add_(1, dg[:, 1], col * dg[:, 2].int())
        if acc is not None:
            out[:, ci * bk:(ci + 1) * bk] = acc
    return out


def _plain_rollout(u_seq, tables, w_in, x0, w_out=None, *, leak=1.0,
                   smax=127, recur_scale=1.0, readout_every=1,
                   want_states=True, want_preds=False, want_final=False,
                   final_out=None):
    """The step loop of the CUDA kernel in PyTorch ops, on any device.

    Walks the same per-column term tables; the state is zero-padded to
    whole column blocks (pad columns stay zero through the recurrence).
    The input projection is summed in ascending input order and the
    epilogue uses separately rounded operations, as the kernel does, so
    every element goes through the kernel's rounding sequence.
    """
    same_device(u_seq.device, tables.tiles, w_in, x0, w_out, final_out)
    t_steps, b, i = u_seq.shape
    dim = x0.shape[-1]
    rpad = tables.n_col_blocks * tables.block
    x = x0.new_zeros((b, rpad))
    x[:, :dim] = x0
    win = w_in.new_zeros((i, rpad))
    win[:, :dim] = w_in
    has_terms = torch.tensor(
        [hi > lo for lo, hi in zip(tables.col_ptr_host,
                                   tables.col_ptr_host[1:])],
        device=x.device).repeat_interleave(tables.block)
    states, preds = [], []
    for t in range(t_steps):
        u = u_seq[t]
        up = u[:, 0:1] * win[0]
        for m in range(1, i):
            up = up + u[:, m:m + 1] * win[m]
        if tables.int8:
            xq = torch.clamp(torch.round(x * smax), -smax - 1,
                             smax).to(torch.int32)
            recur = plain_recurrent_product(xq, tables)
            pre = up + recur.to(torch.float32) * recur_scale
        else:
            pre = torch.where(has_terms,
                              up + plain_recurrent_product(x, tables), up)
        x = (1.0 - leak) * x + leak * torch.tanh(pre)
        if want_states:
            states.append(x[:, :dim])
        if want_preds and (t + 1) % readout_every == 0:
            preds.append(rollout_readout_plain(x[:, :dim], w_out))
    final = None
    if want_final:
        final = x[:, :dim].contiguous()
        if final_out is not None:
            final = final_out.copy_(final)
    return _pack(torch.stack(states) if want_states else None,
                 torch.stack(preds) if want_preds else None, final)


def _dispatch(entry, counted, plain, u_seq, tables, w_in, x0, w_out=None, *,
              leak=1.0, smax=127, recur_scale=1.0, b_tile=16,
              readout_every=1, want_states=True, want_preds=False,
              want_final=False, final_out=None):
    if not (want_states or want_preds or want_final):
        raise ValueError("request at least one of states, preds, final")
    kw = dict(leak=leak, smax=smax, recur_scale=recur_scale,
              readout_every=readout_every, want_states=want_states,
              want_preds=want_preds, want_final=want_final,
              final_out=final_out)
    if u_seq.device.type == "cpu":
        return plain(u_seq, tables, w_in, x0, w_out, **kw)
    return _launch_rollout(entry, counted, u_seq, tables, w_in, x0, w_out,
                           b_tile=b_tile, **kw)


def reservoir_rollout_plain(u_seq, tables, w_in, x0, w_out=None, **kw):
    """Plain twin of :func:`reservoir_rollout` (MM terms only)."""
    if any(r[0] != 0 for r in tables.terms_host):
        raise ValueError("the generic rollout takes MM terms only")
    return _plain_rollout(u_seq, tables, w_in, x0, w_out, **kw)


def reservoir_rollout(u_seq: torch.Tensor, tables: RolloutTables,
                      w_in: torch.Tensor, x0: torch.Tensor,
                      w_out: torch.Tensor | None = None, **kw):
    """B1: T-step generic banded rollout of a state batch.

    Args:
        u_seq: (T, B, I) float32 inputs (unit stride over I).
        tables: :func:`build_tables` of :func:`generic_schedules` of the
            plan's ``rollout_layout`` band plans, on ``u_seq``'s device.
        w_in: (I, dim) input weights; x0: (B, dim) initial states.
        w_out: (dim, O) readout weights (required iff ``want_preds``).
        leak, smax, recur_scale: Eq. 1's leak; int8 state range and the
            ``scale / smax`` factor restoring float pre-activations.
        b_tile: batch rows per thread block.
        readout_every: emit predictions every k steps (k must divide T).
        want_states / want_preds / want_final: which outputs to return.
        final_out: optional (B, dim) buffer that receives x(T) in place
            (the chunked scheduler's carried state).

    Returns states (T, B, dim), preds (T // k, B, O) and the final state
    (B, dim), in that order — bare when exactly one is requested.
    """
    return _dispatch("reservoir_rollout_step", reservoir_rollout,
                     reservoir_rollout_plain, u_seq, tables, w_in, x0,
                     w_out, **kw)


reservoir_rollout.launches = 0
