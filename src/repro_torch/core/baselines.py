"""Analytic baseline models for the paper's evaluation (Section VII).

The reproduction has no V100 and no SIGMA RTL simulator, so the comparison
baselines are implemented as physics-grounded cost models whose free
constants are calibrated once against the anchors the paper states in text:

  GPU (V100, fp16 sparse libraries):
    * "the GPU cannot break the 1 us barrier" (all configs measured)
    * dimension sweep @98% sparsity: speedup falls 86x -> 60x while the GPU
      is latency-bound (dim <= 512), levels at ~50x for dim >= 1024
    * sparsity sweep @1024: 77x @70% -> 60x @98%
    * batching: GPU scales sublinearly; crossover ~batch 16..64 for 64x64

  SIGMA (128x128 fp16 PE grid, assumed 1 GHz for int8/process parity):
    * fits-in-grid -> nanosecond regime; tiling pushes it memory-bound
    * dimension sweep @98%: 4.1x @1024 growing to ~25x @4096
    * sparsity sweep @1024: microsecond regime below ~90% sparsity, max 47x
    * batching @1024/95%: saturates at ~5.4x

Every constant is tagged ``# calibrated:`` with its anchor.  The FPGA side
of every comparison comes from :mod:`repro_torch.core.costmodel` (not
from these tables), so the reproduction logic is: model our design from first
principles, model the baselines from published measurements, and check the
derived speedups against the paper's claims in tests/benchmarks.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["V100Model", "SigmaModel", "gpu_latency_s", "sigma_latency_s"]


@dataclasses.dataclass(frozen=True)
class V100Model:
    """V100 sparse-gemv latency model: library floor + streaming terms."""

    hbm_bw: float = 900e9           # V100 HBM2 bandwidth, B/s
    # calibrated: 86x over a ~40 ns FPGA point at dim 64 (Fig 14)
    cusparse_floor_s: float = 3.45e-6
    # calibrated: optimized kernel [9] "comparatively spends less time
    # indexing"; ~35% lower floor reproduces the 60-77x band (Figs 14/16)
    sputnik_floor_s: float = 2.25e-6
    # floor shrinks mildly with dim as launch overheads amortize;
    # calibrated: 86x@64 -> 60x@512 latency-bound fall-off (Fig 14)
    floor_decay_per_oct: float = 0.92
    # CSR per-nonzero cost: value (2B fp16) + column index (4B) + row ptr
    # amortized + output; effective streaming efficiency ~35% of HBM peak
    # calibrated: ~50x plateau at dim >= 1024 (Fig 14: "linear scaling")
    bytes_per_nnz: float = 6.0
    stream_eff: float = 0.35

    def latency_s(self, dim: int, element_sparsity: float,
                  library: str = "cusparse", batch: int = 1) -> float:
        nnz = dim * dim * (1.0 - element_sparsity)
        floor = (self.cusparse_floor_s if library == "cusparse"
                 else self.sputnik_floor_s)
        floor *= self.floor_decay_per_oct ** math.log2(max(dim, 64) / 64)
        # batched columns reuse the fetched matrix: sublinear scaling
        # ("the latency for the GPU solution scales sublinearly with respect
        #  to batch size")
        vec_bytes = dim * 2.0 * 2.0 * batch
        mat_bytes = nnz * self.bytes_per_nnz
        stream = (mat_bytes + vec_bytes) / (self.hbm_bw * self.stream_eff)
        compute = nnz * batch * 2 / 15.7e12  # fp16 FMA throughput bound
        return max(floor, stream, compute)


@dataclasses.dataclass(frozen=True)
class SigmaModel:
    """SIGMA [20]: 128x128 PE grid, weight-stationary, Benes broadcast.

    One unified latency formula covers the paper's three SIGMA experiments:

      tiles    = ceil(nnz / PEs)                    (weight-stationary fit)
      per_tile = c_tile + c_stream*dim + c_occ*(1-es)
      latency  = base + tiles*per_tile + (batch-1)*c_batch*dim   [cycles]

    c_stream models re-streaming the input segment every tiled pass;
    c_occ models the denser weight/activation pairing at low sparsity
    ("even 90% sparsity and below is enough to push it back into the
    microsecond regime"); c_batch is the incremental activation stream per
    batched column under weight reuse.
    """

    pes: int = 128 * 128
    clock_hz: float = 1e9           # paper's int8/process-parity assumption
    # fits-in-grid latency: broadcast + log-depth reduction + pipeline
    # ("For small dimensions, SIGMA does report nanosecond-scale latency")
    base_cycles: float = 40.0
    # calibrated: 4.1x @ (1024, 98%) and ~25x @ (4096, 98%) (Figs 19-20)
    c_tile: float = 58.4
    c_stream: float = 0.0215
    # calibrated: ~47x max over the 1024 sparsity sweep (Figs 21-22)
    c_occ: float = 600.0
    # calibrated: 5.4x batching saturation @ (1024, 95%) (Fig 23)
    c_batch: float = 0.077

    def latency_s(self, dim: int, element_sparsity: float,
                  batch: int = 1) -> float:
        nnz = dim * dim * (1.0 - element_sparsity)
        # "only maps non-zero weight and activation pairs to PEs"
        if nnz <= self.pes and batch == 1:
            return (self.base_cycles + math.log2(max(dim, 2))) / self.clock_hz
        tiles = math.ceil(nnz / self.pes)
        per_tile = (self.c_tile + self.c_stream * dim
                    + self.c_occ * (1.0 - element_sparsity))
        cycles = (self.base_cycles + tiles * per_tile
                  + (batch - 1) * self.c_batch * dim)
        return cycles / self.clock_hz


_V100 = V100Model()
_SIGMA = SigmaModel()


def gpu_latency_s(dim: int, element_sparsity: float,
                  library: str = "cusparse", batch: int = 1) -> float:
    return _V100.latency_s(dim, element_sparsity, library, batch)


def sigma_latency_s(dim: int, element_sparsity: float,
                    batch: int = 1) -> float:
    return _SIGMA.latency_s(dim, element_sparsity, batch)
