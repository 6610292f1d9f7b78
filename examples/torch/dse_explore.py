"""The paper's design-space exploration on the PyTorch port, interactive.

Given a GEMM workload and a MAC budget, reports: the optimal 2D array,
the optimal tier count, speedup, power/area/thermal for the chosen
config, and how the same decision maps onto a mesh axis of the
advisor's TPU model (its microseconds are priced at TPU v5e constants,
not the card's).

Run:  PYTHONPATH=src python examples/torch/dse_explore.py --m 128 --k 8192 --n 512
Add --pareto to print the latency/area/power Pareto frontier over the
whole (budget x tier) grid via one batched engine call. --device picks
where the thermal grid solve and the engine's search run: cuda (the
default) or cpu.
"""

import argparse

from repro_torch.core.advisor import GemmShard, score_strategies
from repro_torch.core.analytical import (
    optimal_tiers, optimize_array_2d, optimize_array_3d, speedup_3d,
)
from repro_torch.core.ppa import area_normalized_speedup, array_power, thermal_report


def pareto_study(M, K, N, device):
    """Latency-area-power frontier over budgets x tiers (Sec. IV-C/D)."""
    from repro_torch.core.engine import DesignGrid, evaluate

    budgets = [2**p for p in range(12, 19)]
    tiers = range(1, 17)
    grid = DesignGrid.product([(M, K, N)], budgets, tiers)
    res = evaluate(grid, backend="torch", device=device)
    mask = res.pareto_mask(("cycles", "area_um2", "power_w"))[0]
    print(f"\nPareto frontier ({mask.sum()}/{mask.size} points survive):")
    print("  macs     tiers  RxC        cycles      area mm2  power W  T_max C")
    for p in mask.nonzero()[0]:
        b = grid.mac_budgets[p]
        print(
            f"  2^{int(b).bit_length()-1:<6} {grid.tiers[p]:<6} "
            f"{res.rows[0, p]}x{res.cols[0, p]:<8} {res.cycles[0, p]:<11.0f} "
            f"{res.area_um2[0, p]*1e-6:<9.2f} {res.power_w[0, p]:<8.2f} "
            f"{res.t_max_c[0, p]:.0f}"
        )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--k", type=int, default=12100)
    ap.add_argument("--n", type=int, default=147)
    ap.add_argument("--macs", type=int, default=2**16)
    ap.add_argument("--mesh-axis", type=int, default=16)
    ap.add_argument("--pareto", action="store_true",
                    help="engine-backed latency/area/power Pareto frontier")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    M, K, N, budget = args.m, args.k, args.n, args.macs

    p2 = optimize_array_2d(M, K, N, budget)
    print(f"2D optimum:  {p2.rows}x{p2.cols} -> {p2.cycles:.0f} cycles")
    l, _ = optimal_tiers(M, K, N, budget)
    p3 = optimize_array_3d(M, K, N, budget, l)
    print(f"3D optimum:  {l} tiers of {p3.rows}x{p3.cols} -> {p3.cycles:.0f} cycles "
          f"({speedup_3d(M, K, N, budget, l):.2f}x)")

    for tech in ("tsv", "miv"):
        ans = area_normalized_speedup(M, K, N, budget, l, tech)
        pw = array_power(M, K, N, p3.rows, p3.cols, l, tech)
        th = thermal_report(p3.rows * p3.cols, min(l, 4), tech, M=M, K=K, N=N,
                            device=args.device)
        print(f"  {tech.upper()}: perf/area {ans:.2f}x vs 2D | {pw.total_w:.2f} W "
              f"| T_max {th.t_max_c:.0f} C (budget_ok={th.within_budget})")

    print(f"\nTPU mesh axis of {args.mesh_axis} (the 'tiers'; the advisor's TPU v5e "
          "model, not this device):")
    for s in score_strategies(GemmShard(M=M, K=K, N=N, axis=args.mesh_axis)):
        print(f"  {s.name:10s} compute {s.compute_s*1e6:9.2f}us "
              f"coll {s.collective_s*1e6:9.2f}us total {s.total_s*1e6:9.2f}us")

    if args.pareto:
        pareto_study(M, K, N, args.device)


if __name__ == "__main__":
    main()
