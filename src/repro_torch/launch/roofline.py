"""Roofline on one NVIDIA H100: the LM substrate's analytic model and the
specialized reservoir rollout.

Peaks are the H100 SXM's published figures (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): 989 TFLOP/s bf16 on the tensor
cores, 3.35 TB/s HBM, NVLink 4 at 450 GB/s per direction (18 links).

The LM half (``model_flops``, ``kv_cache_bytes``, ``analytic_hbm_bytes``,
``active_params``) is the JAX package's analytic model, unchanged: 2*N*D
FLOPs for inference (6*N*D for training) and a documented napkin model of
the HBM traffic per step.  ``cell_report`` assembles three terms per dry-run
cell (``launch/dryrun.py``'s records, either package's) at these peaks:

  compute    = dot_FLOPs_per_device / PEAK_FLOPS
  memory     = HBM_traffic_per_device / HBM_BW (the analytic model)
  collective = collective_bytes_per_device / LINK_BW

with MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (inference), the
useful-compute ratio MODEL_FLOPS / (dot FLOPs * devices), the dominant term
and a one-line "what would move it" note; ``to_markdown`` tables them.

Two terms per rollout schedule:

  compute = folded-tile MACs at the tensor-core int8 rate (1,979 TOP/s)
            or the CUDA-core fp32 rate (67 TFLOP/s), one MAC = 2 ops,
            + shift-add digits at the shared-memory atomic rate below
  memory  = the bytes of the kernel's per-block shares (the folded tiles
            and 4 bytes per shift-add digit) over HBM at 3.35 TB/s: once
            per call when the grid keeps them in shared memory, once per
            step when it does not

The memory term follows ``rollout.cu``, not the JAX package's regime:
the kernel repacks every band into per-block shares whatever the band
budget, so the budget moves no byte.
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.costmodel import rollout_cost_features

__all__ = ["DIGIT_BYTES", "HBM_BW", "LINK_BW", "PEAK_FLOPS",
           "PEAK_FP32_FLOPS", "PEAK_INT8_OPS", "RESULTS", "SHIFTADD_OPS",
           "active_params", "analytic_hbm_bytes", "cell_report",
           "expert_params_per_layer", "kv_cache_bytes", "load_all", "main",
           "model_flops", "rollout_roofline", "to_markdown"]

PEAK_FLOPS = 989e12       # bf16 tensor-core FLOP/s
PEAK_INT8_OPS = 1979e12   # int8 tensor-core ops/s
PEAK_FP32_FLOPS = 67e12   # fp32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12          # B/s
LINK_BW = 450e9           # B/s, NVLink 4 per direction
# rollout.cu adds each shift-add digit into a shared int32 accumulator with
# one shared-memory atomic add: at most one per bank per clock, 32 per SM,
# over 132 SMs at the 1.98 GHz boost clock (data sheet)
SHIFTADD_OPS = 32 * 132 * 1.98e9
DIGIT_BYTES = 4           # one packed uint32 per digit in a block's share

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


# ---------------------------------------------------------------------------
# the LM substrate's analytic model (the JAX package's, unchanged)
# ---------------------------------------------------------------------------
def expert_params_per_layer(cfg: ModelConfig) -> int:
    if cfg.moe is None:
        return 0
    return 3 * cfg.d_model * cfg.moe.d_expert


def active_params(cfg: ModelConfig, total: int) -> int:
    """Parameters touched per token (MoE: top_k + shared experts only)."""
    if cfg.moe is None:
        return total
    per = expert_params_per_layer(cfg)
    inactive = (cfg.moe.n_experts - cfg.moe.top_k) * per * cfg.n_layers
    return total - inactive


def model_flops(cfg: ModelConfig, shape: ShapeSpec, n_active: int) -> float:
    """6*N*D for training, 2*N*D for inference (D = tokens this step)."""
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token


def kv_cache_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Global KV/state cache bytes at full context."""
    b, s = shape.global_batch, shape.seq_len
    per_layer = 0.0
    for kind in cfg.block_pattern:
        if kind == "attn":
            per_layer += 2 * cfg.n_kv_heads * cfg.head_dim * s * 2.0
        elif kind == "local":
            w = min(cfg.window or s, s)
            per_layer += 2 * cfg.n_kv_heads * cfg.head_dim * w * 2.0
        elif kind == "mla":
            per_layer += (cfg.mla.kv_lora + cfg.mla.rope_dim) * s * 2.0
        elif kind == "rglru":
            per_layer += (cfg.lru_dim * 4.0
                          + (cfg.conv_width - 1) * cfg.lru_dim * 4.0)
        elif kind in ("mlstm", "slstm"):
            per_layer += (cfg.n_heads * (cfg.head_dim ** 2 + 2 * cfg.head_dim)
                          * 4.0)
    n_per_pattern = cfg.n_layers / max(len(cfg.block_pattern), 1)
    return b * per_layer * n_per_pattern


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeSpec, n_total: int,
                       n_active: int, n_dev: int,
                       weight_bytes_per_param: float = 2.0) -> float:
    """Per-device HBM traffic per step (documented napkin model).

    train:  weights read fwd+bwd+remat-recompute (3x) + grad write (4B)
            + AdamW m/v read+write (16B) + param write (2B)
            + activation stream ~12 x tokens x d_model x layers x 2B
    prefill: active weights read once + activation stream ~6x + cache write
    decode:  active weights read once (every step!) + full cache read
    """
    toks_dev = shape.global_batch * shape.seq_len / n_dev
    d, nl = cfg.d_model, cfg.n_layers
    if shape.kind == "train":
        p_dev = n_total / n_dev
        w = p_dev * (3 * weight_bytes_per_param + 4 + 16 + 2)
        acts = 12.0 * toks_dev * d * nl * 2.0
        return w + acts
    if shape.kind == "prefill":
        p_dev = n_active / n_dev  # inactive experts untouched per token-block
        acts = 6.0 * toks_dev * d * nl * 2.0
        cache = kv_cache_bytes(cfg, shape) / n_dev
        return p_dev * weight_bytes_per_param + acts + cache
    # decode
    p_dev = n_active / n_dev
    cache = kv_cache_bytes(cfg, shape) / n_dev
    return p_dev * weight_bytes_per_param + cache


# ---------------------------------------------------------------------------
# the specialized reservoir rollout
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# assembly: the dry run's cells
# ---------------------------------------------------------------------------
def _advice(dom: str, cfg: ModelConfig, shape: ShapeSpec) -> str:
    if dom == "collective":
        if cfg.moe is not None:
            return ("replicated-dispatch EP psums full activations every MoE "
                    "layer; switch combine to reduce-scatter + seq-sharding")
        return "shard more weights FSDP to turn all-reduces into reduce-scatters"
    if dom == "memory":
        if shape.kind == "decode":
            return ("weights re-read every token: int8/CSD frozen-weight "
                    "serving (paper technique) halves the stream")
        return "raise arithmetic intensity: bigger per-device batch or less remat"
    return "compute-bound: good; next win is overlap of FSDP gathers with matmuls"


def cell_report(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    n_dev = rec["n_devices"]
    n_total = rec["param_count"]
    n_act = active_params(cfg, n_total)

    flops_dev = rec["hlo_walk"]["dot_flops"] + rec["hlo_walk"]["conv_flops"]
    coll_dev = rec["hlo_walk"]["total_collective_bytes"]
    hbm_dev = analytic_hbm_bytes(cfg, shape, n_total, n_act, n_dev)

    t_c = flops_dev / PEAK_FLOPS
    t_m = hbm_dev / HBM_BW
    t_n = coll_dev / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_n}
    dom = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, n_act)
    hlo_global = flops_dev * n_dev
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
        "dominant": dom,
        "model_flops": mf,
        "useful_ratio": mf / hlo_global if hlo_global else float("nan"),
        "step_s_bound": max(terms.values()),
        "roofline_frac": (terms["compute"] / max(terms.values())
                          if max(terms.values()) > 0 else 0.0),
        "peak_mem_gb": rec["memory_per_device"]["peak_bytes"] / 2**30,
        "advice": _advice(dom, cfg, shape),
    }


def load_all(mesh_dir: str = "pod16x16", variants: bool = False) -> list:
    out = []
    for p in sorted((RESULTS / mesh_dir).glob("*.json")):
        rec = json.loads(p.read_text())
        if bool(rec.get("variant")) != variants:
            continue
        out.append(rec)
    return out


def to_markdown(reports: list) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| 6ND/HLO | roofline frac | mem GB/dev | next lever |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in reports:
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.2e} "
            f"| {r['memory_s']:.2e} | {r['collective_s']:.2e} "
            f"| **{r['dominant']}** | {r['useful_ratio']:.2f} "
            f"| {r['roofline_frac']:.2f} | {r['peak_mem_gb']:.1f} "
            f"| {r['advice']} |")
    return hdr + "\n".join(rows)


def main():
    recs = load_all()
    reports = [r for r in (cell_report(x) for x in recs) if r]
    print(to_markdown(reports))
    out = RESULTS / "roofline.md"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(to_markdown(reports) + "\n")
    print(f"\nwrote {out}")


if __name__ == "__main__":
    main()
