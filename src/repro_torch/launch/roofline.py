"""Roofline of the specialized reservoir rollout on one NVIDIA H100.

Two terms per rollout schedule, against the H100 SXM's published peaks
(NVIDIA's data sheet, dense rates, at the full 700 W power limit):

  compute = folded-tile MACs at the tensor-core int8 rate (1,979 TOP/s)
            or the CUDA-core fp32 rate (67 TFLOP/s), one MAC = 2 ops,
            + shift-add digits at the shared-memory atomic rate below
  memory  = the bytes of the kernel's per-block shares (the folded tiles
            and 4 bytes per shift-add digit) over HBM at 3.35 TB/s: once
            per call when the grid keeps them in shared memory, once per
            step when it does not

The memory term follows ``rollout.cu``, not the JAX package's regime:
the kernel repacks every band into per-block shares whatever the band
budget, so the budget moves no byte.  The half of the JAX package's
``launch/roofline.py`` that prices the LM substrate waits for the LM
configs.
"""

from __future__ import annotations

from repro_torch.core.costmodel import rollout_cost_features

__all__ = ["DIGIT_BYTES", "HBM_BW", "PEAK_FP32_FLOPS", "PEAK_INT8_OPS",
           "SHIFTADD_OPS", "rollout_roofline"]

PEAK_INT8_OPS = 1979e12   # int8 tensor-core ops/s
PEAK_FP32_FLOPS = 67e12   # fp32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12          # B/s
# rollout.cu adds each shift-add digit into a shared int32 accumulator with
# one shared-memory atomic add: at most one per bank per clock, 32 per SM,
# over 132 SMs at the 1.98 GHz boost clock (data sheet)
SHIFTADD_OPS = 32 * 132 * 1.98e9
DIGIT_BYTES = 4           # one packed uint32 per digit in a block's share


def rollout_roofline(summary: dict, block: int, batch: int,
                     steps: int = 1, *, resident: bool = True) -> dict:
    """Roofline view of one specialized rollout schedule on the H100:
    compute (folded-tile MACs on the int8 tensor cores, or fp32 FMAs on
    the CUDA cores, plus the shift-add digits as shared-memory atomic
    adds at :data:`SHIFTADD_OPS`) against memory (the shares' bytes, read
    once per call if ``resident`` — the grid keeps them in shared memory,
    ``plan_grid``'s ``resident`` — else once per step).  The plan
    autotuner uses this view for reporting; its pruning uses the
    calibrated linear model in :mod:`repro_torch.core.costmodel`, which
    this shares its feature extraction with so the two can never disagree
    about what a schedule *does*.
    """
    f = rollout_cost_features(summary, block, batch, steps)
    fp32 = summary["mode"] == "fp32"
    peak = PEAK_FP32_FLOPS if fp32 else PEAK_INT8_OPS
    t_c = 2.0 * f["matmul_macs"] / peak + f["shiftadd_ops"] / SHIFTADD_OPS
    share = (summary["n_matmul_terms"] * block * block * (4 if fp32 else 1)
             + summary["shiftadd_digits"] * DIGIT_BYTES)
    t_m = share * (1 if resident else steps) / HBM_BW
    terms = {"compute": t_c, "memory": t_m}
    dom = max(terms, key=terms.get)
    if dom == "memory" and not resident:
        advice = ("the shares overflow shared memory and are re-read every "
                  "step: a higher crossover moves planes into shift-add "
                  "digits and shrinks them")
    elif dom == "memory":
        advice = ("the one pass over the shares dominates: more steps per "
                  "call amortize it, or drop fp32 tiles to int8")
    else:
        advice = ("compute-bound: good; next lever is the shift-add "
                  "crossover (trade tensor-core tiles against atomic adds)")
    return {"compute_s": t_c, "memory_s": t_m, "dominant": dom,
            "bound_s": max(terms.values()), "advice": advice}
