"""Serving layer: batched reservoir rollouts behind request batching.

- ``api``       — SubmitSpec / RolloutResult, the one request/response
  contract shared by every entry point
- ``engine``    — ReservoirEngine: rollout through the CUDA kernels
- ``batching``  — padding-bucket request batching
- ``scheduler`` — continuous batching: slot pool + time-stamped queue,
  chunked rollouts with per-slot reservoir-state carry
- ``stats``     — throughput / latency / padding / queue telemetry
"""

from repro_torch.serve.api import RolloutResult, SubmitSpec  # noqa: F401
from repro_torch.serve.batching import (MicroBatch,  # noqa: F401
                                        PaddingBucketer, RolloutRequest)
from repro_torch.serve.engine import (ReservoirEngine,  # noqa: F401
                                      engine_cache_clear, engine_cache_stats,
                                      engine_for)
from repro_torch.serve.scheduler import (AsyncReservoirServer,  # noqa: F401
                                         ContinuousBatcher, QueuedRequest)
from repro_torch.serve.stats import ServeStats  # noqa: F401

__all__ = ["SubmitSpec", "RolloutResult", "ReservoirEngine", "engine_for",
           "engine_cache_clear", "engine_cache_stats", "ServeStats",
           "PaddingBucketer", "RolloutRequest", "MicroBatch",
           "AsyncReservoirServer", "ContinuousBatcher", "QueuedRequest"]
