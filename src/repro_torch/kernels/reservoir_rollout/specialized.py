"""Plan-specialized rollout (B2): folded tiles, shift-add digits, batch tiles.

The generic banded kernel (:mod:`.reservoir_rollout`) reduces one per-plane
tile product per kept (plane, block).  This kernel consumes a
:class:`repro_torch.plan.RolloutProgram` instead:

* ``MM`` terms multiply a *folded* tile — the int8 digit planes of a block
  collapsed into the quantized block, one exact int32 tile product instead
  of ``width`` shifted plane products;
* ``SA`` terms add a sparse plane's few set digits as ``±(x << w)``
  shift-adds (integer atomics into a shared accumulator on the GPU);
* the batch axis splits into tiles of at most ``batch_tile_max`` rows
  (at most 16 on the GPU, one MMA tile), which every thread block walks
  in turn for its own column slice.

int8 terms accumulate in exact int32, so every schedule is bit-identical
to the generic kernel; fp32 terms keep its ascending-row order.  The
program's regime (``resident`` / ``pipelined``) changes only how columns
group into bands, which only the plain twin walks: the CUDA kernel
repacks every band's tiles into per-thread-block shares
(:func:`~.reservoir_rollout.pack_blocks`) and keeps them in shared memory
when they fit, whatever the regime.
"""

from __future__ import annotations

import torch

from repro_torch.core.sparse import FixedMatrix
from repro_torch.kernels.reservoir_rollout.ops import RolloutOp
from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
    RolloutTables, _dispatch, _plain_rollout, build_tables)
from repro_torch.plan import (DEFAULT_BATCH_TILE, DEFAULT_VMEM_BUDGET,
                              ExecutionPlan, specialize_rollout)

__all__ = ["SpecializedRollout", "specialized_rollout",
           "specialized_rollout_plain"]


def specialized_rollout_plain(u_seq, tables, w_in, x0, w_out=None, **kw):
    """Plain twin of :func:`specialized_rollout` (MM and SA terms)."""
    return _plain_rollout(u_seq, tables, w_in, x0, w_out, **kw)


def specialized_rollout(u_seq: torch.Tensor, tables: RolloutTables,
                        w_in: torch.Tensor, x0: torch.Tensor,
                        w_out: torch.Tensor | None = None, **kw):
    """B2: T-step program-specialized rollout of a state batch.

    ``tables`` is :func:`build_tables` of a :class:`RolloutProgram`'s
    schedules and data; ``b_tile`` is the program's batch tile.  The other
    arguments and the outputs are those of
    :func:`~.reservoir_rollout.reservoir_rollout`.
    """
    return _dispatch(specialized_rollout, specialized_rollout_plain, u_seq,
                     tables, w_in, x0, w_out, **kw)


specialized_rollout.launches = 0


class SpecializedRollout(RolloutOp):
    """Program-driven rollout for one frozen reservoir.

    Drop-in for :class:`..ops.FusedRollout` with the plan-specialized
    lowering behind it: the regime, batch tiling and the folded/shift-add
    schedule all come from :func:`repro_torch.plan.specialize_rollout`.
    """

    def __init__(self, source: FixedMatrix | ExecutionPlan, w_in, *,
                 leak: float = 1.0, mode: str = "fp32", state_bits: int = 8,
                 w_out=None, vmem_budget: int | None = DEFAULT_VMEM_BUDGET,
                 readout_every: int = 1,
                 batch_tile_max: int = DEFAULT_BATCH_TILE,
                 crossover: int | None = None, device=None):
        super().__init__(source, w_in, leak=leak, mode=mode,
                         state_bits=state_bits, w_out=w_out,
                         readout_every=readout_every, device=device)
        self.program = specialize_rollout(
            self.plan, mode, vmem_budget=vmem_budget, crossover=crossover,
            batch_tile_max=batch_tile_max)
        self.tables = build_tables(
            self.program.schedules, self.program.data, mode=mode,
            n_col_blocks=self.plan.nbc, device=self.device)

    @property
    def regime(self) -> str:
        return self.program.regime

    @property
    def n_bands(self) -> int:
        return self.program.n_bands

    def _batch_tile(self, batch: int) -> int:
        return self.program.batch_tiling(batch)[0]

    def _launch(self, u_seq, x0, **kw):
        return specialized_rollout(u_seq, self.tables, self.w_in, x0, **kw)
