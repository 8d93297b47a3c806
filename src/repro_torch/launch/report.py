"""Dry-run and roofline tables from the dry run's results (idempotent),
plus the ExecutionPlan compile/cost table used by the serving examples.

``python -m repro_torch.launch.report`` prints both tables from
``results/dryrun_torch/``; the "peak fits" column holds each cell's memory
per device to the H100's 80 GB (``HBM_GB``).
"""

from __future__ import annotations

from pathlib import Path

from repro_torch.launch import roofline

__all__ = ["HBM_GB", "ROOT", "dryrun_table", "main", "plan_table",
           "roofline_table"]

ROOT = Path(__file__).resolve().parents[3]
HBM_GB = 80      # the H100's memory per card


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


def dryrun_table() -> str:
    rows = ["| arch | shape | mesh | status | step | mem/dev GB | peak fits "
            f"{HBM_GB}GB | dot FLOPs/dev | collective B/dev | compile s |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for mesh_dir, mesh_name in (("pod16x16", "16x16"),
                                ("pod2x16x16", "2x16x16")):
        for rec in roofline.load_all(mesh_dir):
            if rec.get("status") == "ok":
                m = rec["memory_per_device"]
                tot = (m["argument_bytes"] + m["temp_bytes"]) / 2 ** 30
                rows.append(
                    f"| {rec['arch']} | {rec['shape']} | {mesh_name} | ok "
                    f"| {rec.get('step', '')} | {tot:.1f} "
                    f"| {'yes' if tot <= HBM_GB else 'NO'} "
                    f"| {rec['hlo_walk']['dot_flops']:.2e} "
                    f"| {rec['hlo_walk']['total_collective_bytes']:.2e} "
                    f"| {rec.get('t_compile_s', '')} |")
            elif rec.get("status") == "skipped":
                rows.append(f"| {rec['arch']} | {rec['shape']} | {mesh_name} "
                            f"| skipped (documented) | — | — | — | — | — | — |")
            else:
                rows.append(f"| {rec['arch']} | {rec['shape']} | {mesh_name} "
                            f"| **{rec.get('status')}** | — | — | — | — | — | — |")
    return "\n".join(rows)


def roofline_table() -> str:
    recs = roofline.load_all("pod16x16")
    reports = [r for r in (roofline.cell_report(x) for x in recs) if r]
    return roofline.to_markdown(reports)


def main():
    print("== dryrun ==")
    print(dryrun_table())
    print("\n== roofline ==")
    print(roofline_table())


if __name__ == "__main__":
    main()
