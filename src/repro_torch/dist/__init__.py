"""Sharded multi-device serving: batch-axis data parallelism.

The reservoir matrix is fixed and replicated (the paper's core premise),
so scaling serving throughput is pure batch-axis data parallelism with no
collective in the rollout hot loop:

- ``engine``    — :class:`ShardedReservoirEngine`: one single-device
  engine replica per mesh device (plan tables, ``W_in`` and ``W_out``
  placed once per device), the batch split into contiguous slices, one
  rollout launch per shard, bit-identical per sequence to the
  single-device engine
- ``scheduler`` — :class:`ShardedContinuousBatcher` (per-shard slot
  sub-pools, least-loaded admission off one global FIFO, no launch on a
  shard without a live slot) and :class:`DistributedReservoirServer`
  (merged + per-shard telemetry, elastic
  :meth:`~DistributedReservoirServer.shrink` on shard loss and
  :meth:`~DistributedReservoirServer.grow` under live traffic, driven
  manually or by a :class:`~repro_torch.runtime.elastic.AutoscalePolicy`;
  fault-plan shard deaths recover through the same shrink path with zero
  request loss)
"""

from repro_torch.dist.engine import ShardedReservoirEngine  # noqa: F401
from repro_torch.dist.scheduler import (  # noqa: F401
    DistributedReservoirServer, ShardedContinuousBatcher)

__all__ = ["ShardedReservoirEngine", "ShardedContinuousBatcher",
           "DistributedReservoirServer"]
