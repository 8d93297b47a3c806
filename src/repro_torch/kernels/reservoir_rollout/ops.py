"""ExecutionPlan -> rollout launch.

The offline lowering lives in :mod:`repro_torch.plan`: the reservoir matrix
is frozen, so the reduction structure (which blocks exist, which digit
plane-blocks are populated) is compiled once there, unbanded, and
flattened here into per-column term tables on the device
(:func:`~.reservoir_rollout.build_tables`).  On the card the kernel cuts
them into per-thread-block shares, and
:func:`~.reservoir_rollout.plan_grid` decides from the card's shared
memory whether they stay resident.  These wrappers only place the
per-instance operands (w_in, w_out, the tables) on the device once and
dispatch.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sparse import FixedMatrix
from repro_torch.device import resolve_device
from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
    build_tables, generic_schedules, reservoir_rollout)
from repro_torch.plan import DEFAULT_BATCH_TILE, ExecutionPlan, plan_for

__all__ = ["FusedRollout"]


class RolloutOp:
    """What both rollout ops share: square-plan checks, operands on the
    device, and the output contract of ``__call__``."""

    def __init__(self, source, w_in, *, leak, mode, state_bits, w_out,
                 readout_every, device):
        plan = source if isinstance(source, ExecutionPlan) else plan_for(source)
        if plan.shape[0] != plan.shape[1] or plan.nbr != plan.nbc:
            raise ValueError("reservoir matrix must be square")
        if mode not in ("fp32", "int8"):
            raise ValueError(f"mode must be fp32 or int8, not {mode!r}")
        self.plan = plan
        self.device = resolve_device(device)
        self.dim = plan.shape[0]
        self.block = plan.block
        self.leak = float(leak)
        self.mode = mode
        self.readout_every = int(readout_every)
        self.smax = (1 << (state_bits - 1)) - 1
        self.recur_scale = plan.scale / self.smax
        as_t = lambda a: torch.as_tensor(                     # noqa: E731
            np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                       np.float32), device=self.device).contiguous()
        self.w_in = as_t(w_in)
        self.w_out = None
        self.out_dim = 0
        if w_out is not None:
            self.w_out = as_t(w_out)
            if self.w_out.shape[0] != self.dim:
                raise ValueError(f"w_out rows {self.w_out.shape[0]} != "
                                 f"dim {self.dim}")
            self.out_dim = self.w_out.shape[1]

    def _batch_tile(self, batch: int) -> int:
        raise NotImplementedError

    def _launch(self, u_seq, x0, **kw):
        raise NotImplementedError

    def __call__(self, u_seq: torch.Tensor, x0: torch.Tensor | None = None,
                 *, want_states: bool = True, want_preds: bool = False,
                 want_final: bool = False, donate_state: bool = False):
        """u_seq: (T, B, I) -> the requested outputs, in order: states
        (T, B, dim), preds (T // readout_every, B, out_dim), final state
        (B, dim).  A bare tensor when exactly one is requested, else a
        tuple.  ``want_final`` hands back x(T) so a later chunk can resume
        bit-identically; ``donate_state`` writes it into ``x0`` in place
        (the chunked scheduler's carried states) and returns ``x0``."""
        if want_preds and self.w_out is None:
            raise ValueError("readout requested but no w_out attached")
        u_seq = torch.as_tensor(u_seq, dtype=torch.float32,
                                device=self.device)
        b = u_seq.shape[1]
        if x0 is None:
            x0 = torch.zeros((b, self.dim), device=self.device)
        elif donate_state:
            if not (isinstance(x0, torch.Tensor) and x0.is_contiguous()
                    and x0.dtype == torch.float32
                    and x0.device == self.device):
                raise ValueError("donate_state needs x0 as a contiguous "
                                 "float32 tensor on the op's device")
        else:
            x0 = torch.as_tensor(x0, dtype=torch.float32,
                                 device=self.device).contiguous()
        final_out = x0 if (donate_state and want_final) else None
        return self._launch(
            u_seq, x0, w_out=self.w_out if want_preds else None,
            leak=self.leak, smax=self.smax, recur_scale=self.recur_scale,
            b_tile=self._batch_tile(b), readout_every=self.readout_every,
            want_states=want_states, want_preds=want_preds,
            want_final=want_final, final_out=final_out)


class FusedRollout(RolloutOp):
    """Generic rollout (B1) for one frozen reservoir.

    Offline (init): take the shared :class:`~repro_torch.plan.ExecutionPlan`
    (building it if handed a raw FixedMatrix), lower the mode's rollout
    layout unbanded and place its tables on the device.  Online
    (``__call__``): :func:`reservoir_rollout` rolls the whole (T, B)
    workload in one launch; with ``w_out`` attached the readout is
    computed inside it after each (k-th) step.
    """

    def __init__(self, source: FixedMatrix | ExecutionPlan, w_in, *,
                 leak: float = 1.0, mode: str = "fp32", state_bits: int = 8,
                 w_out=None, readout_every: int = 1, device=None):
        super().__init__(source, w_in, leak=leak, mode=mode,
                         state_bits=state_bits, w_out=w_out,
                         readout_every=readout_every, device=device)
        self.layout = self.plan.rollout_layout(mode, vmem_budget=None)
        self.n_terms = self.layout.n_terms
        self.tables = build_tables(
            generic_schedules(self.layout.band_plans()), self.layout.data,
            mode=mode, n_col_blocks=self.plan.nbc, device=self.device)

    def _batch_tile(self, batch: int) -> int:
        # the TPU kernel has no batch tiling; rows per batch tile follow
        # the specialized program's default tile, balanced the same way
        n_tiles = max(1, -(-batch // DEFAULT_BATCH_TILE))
        return -(-batch // n_tiles)

    def _launch(self, u_seq, x0, **kw):
        return reservoir_rollout(u_seq, self.tables, self.w_in, x0, **kw)
