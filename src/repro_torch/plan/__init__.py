"""Matrix -> ExecutionPlan compiler (the paper's synthesis step).

One offline lowering of a :class:`repro_torch.core.sparse.FixedMatrix`
produces every static artefact the kernels, the serve engine and the cost
reports consume: gathered nonzero tiles, per-column reduction term lists
(with block- and plane-level culling), whole-plane masks, padded digit
planes, the sorted BCSR tile list, banded rollout layouts, and the FPGA
cost model attached to the exact decomposed structure.  :mod:`~repro_torch.plan.specialize` folds and strength-reduces
that plan into the rollout program the CUDA kernels walk.
"""

from repro_torch.plan.plan import (
    DEFAULT_VMEM_BUDGET,
    BandedRollout,
    BcsrLayout,
    ExecutionPlan,
    PlanStats,
    RolloutBand,
    plan_cache_stats,
    plan_for,
)
from repro_torch.plan.specialize import (
    DEFAULT_BATCH_TILE,
    RolloutProgram,
    specialize_rollout,
    specialize_summary,
)

__all__ = [
    "DEFAULT_BATCH_TILE",
    "DEFAULT_VMEM_BUDGET",
    "BandedRollout",
    "BcsrLayout",
    "ExecutionPlan",
    "PlanStats",
    "RolloutBand",
    "RolloutProgram",
    "plan_cache_stats",
    "plan_for",
    "specialize_rollout",
    "specialize_summary",
]
