"""Network-level design-space exploration on the PyTorch port, interactive.

Lower any model-zoo architecture to its GEMM workload stream and
schedule it end-to-end on the 3D-array design grid: per-layer-optimal
vs one fixed array design, with thermal feasibility masking. Each run
is a declarative ``core.study.Study`` — add ``--spec`` to print the
spec JSON instead of running it (feed it to ``python -m repro_torch run``).

Run:  PYTHONPATH=src python examples/torch/network_explore.py --arch qwen2.5-3b
      PYTHONPATH=src python examples/torch/network_explore.py \\
          --arch deepseek-moe-16b --shape decode_32k --tech miv
Add --stream to print the lowered per-layer GEMM stream, and
--thermal-limit to tighten the junction budget and watch designs drop
off the feasible set. --device picks where the engine's search runs:
cuda (the default) or cpu.
"""

import argparse

from repro_torch.configs import REGISTRY, SHAPES
from repro_torch.core.study import AnalysisSpec, ConstraintSpec, SpaceSpec, Study, WorkloadSpec


def build_study(arch, shape, dataflow, tech, thermal_limit, device):
    kw = {}
    if thermal_limit is not None:
        kw["constraints"] = ConstraintSpec(thermal_limit_c=thermal_limit)
    return Study(
        name=f"network-explore-{arch}-{shape}",
        workload=WorkloadSpec(kind="network", arch=arch, shape=shape),
        space=SpaceSpec(dataflow=dataflow, tech=tech),
        analysis=AnalysisSpec(kind="schedule", device=device),
        **kw,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=sorted(REGISTRY))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES),
                    help="default: train_4k, prefill_32k and decode_32k")
    ap.add_argument("--tech", default="tsv", choices=["tsv", "miv"])
    ap.add_argument("--dataflow", default="dos", choices=["dos", "ws", "is"])
    ap.add_argument("--thermal-limit", type=float, default=None,
                    help="junction limit [C]; default: the 105C budget")
    ap.add_argument("--stream", action="store_true",
                    help="print the lowered GEMM stream per shape")
    ap.add_argument("--spec", action="store_true",
                    help="print the Study spec JSON instead of running")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = REGISTRY[args.arch]
    shapes = [args.shape] if args.shape else ["train_4k", "prefill_32k", "decode_32k"]

    for shape_name in shapes:
        if shape_name == "long_500k" and not cfg.is_subquadratic:
            print(f"\n== {shape_name}: skipped (full attention at 500k)")
            continue
        study = build_study(args.arch, shape_name, args.dataflow, args.tech,
                            args.thermal_limit, args.device)
        if args.spec:
            print(study.to_json())
            continue
        stream = study.workload.resolve()
        print(f"\n== {cfg.name} / {shape_name} ({stream.mode}) — "
              f"{stream.workloads.shape[0]} unique GEMMs, "
              f"{stream.n_gemm_invocations} invocations, "
              f"{stream.total_macs:.3e} MACs, "
              f"{stream.arithmetic_intensity():.1f} MACs/DRAM-byte")
        if args.stream:
            for g in stream.gemms:
                print(f"   {g.name:16s} M={g.M:<7d} K={g.K:<7d} N={g.N:<7d} "
                      f"x{g.count}")
        rep = study.run().report
        for pol in (rep.per_layer, rep.fixed):
            if not pol.feasible:
                print(f"   {pol.policy:9s}: NO feasible design under the "
                      f"thermal limit ({rep.thermal_limit:.0f} C)")
                continue
            d = pol.design if pol.policy == "fixed" else pol.design[0]
            tag = (f"{int(d[0])}x{int(d[1])}x{int(d[2])}"
                   + ("" if pol.policy == "fixed" else " (first layer)"))
            print(f"   {pol.policy:9s}: {pol.total_cycles:.3e} cycles "
                  f"({pol.time_s*1e3:.2f} ms) | {pol.speedup_vs_2d:.2f}x vs 2D "
                  f"| {pol.energy_j:.2e} J | EDP {pol.edp_js:.2e} Js "
                  f"| util {pol.utilization:.2f} | T_max {pol.t_max_c:.0f} C "
                  f"| {tag}")
        if rep.n_thermally_masked:
            print(f"   {rep.n_thermally_masked}/{rep.n_candidates} candidate "
                  f"designs thermally masked at {rep.thermal_limit:.0f} C")


if __name__ == "__main__":
    main()
