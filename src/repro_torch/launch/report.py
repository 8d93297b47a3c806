"""The ExecutionPlan compile/cost table used by the serving examples.

The reference module also renders the dry-run and roofline sections of
EXPERIMENTS.md from the dry-run results (``dryrun_table``,
``roofline_table``, ``main``); those wait for the dry run of ROADMAP A12f3.
"""

from __future__ import annotations

__all__ = ["plan_table"]


def plan_table(plans) -> str:
    """Markdown table of ExecutionPlan compile stats + FPGA cost.

    One row per compiled matrix: what the shared lowering kept vs culled,
    how the fp32 rollout bands under the default VMEM budget, and the
    paper's synthesis-model numbers (LUTs ~ ones, Fmax band, Eq. 5
    latency) evaluated on the exact decomposed structure.
    """
    rows = ["| matrix | blocks kept | int8 terms kept/culled | bands "
            "| ones | LUTs | Fmax MHz | Eq.5 ns | W |",
            "|---|---|---|---|---|---|---|---|---|"]
    for plan in plans:
        s = plan.stats
        dp = plan.fpga_cost()
        # partition only: reporting must not gather the banded tile data
        n_bands, band_bytes = plan.band_summary("fp32")
        rows.append(
            f"| {plan.shape[0]}x{plan.shape[1]}/{plan.mode} "
            f"| {s.blocks_nnz}/{s.blocks_total} "
            f"| {s.int8_terms_kept}/{s.int8_terms_culled} "
            f"| {n_bands} x {band_bytes // 1024} KiB "
            f"| {s.ones} | {dp.luts:.0f} | {dp.fmax_hz / 1e6:.0f} "
            f"| {dp.latency_ns:.1f} | {dp.power_w:.1f} |")
    return "\n".join(rows)
