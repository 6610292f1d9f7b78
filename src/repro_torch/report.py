"""The report: the paper's DSE, roofline, network, search, calibrate,
serve, thermal and dry-run sections, computed by the port.

    PYTHONPATH=src python -m repro_torch report                  # on the card
    PYTHONPATH=src python -m repro_torch report --device cpu --sections dse network

The JAX package's counterpart is ``experiments/make_report.py``; this
module keeps its section functions, names and signatures, each with a
``device`` argument threaded into every ``Study`` (``None``: the card).
The roofline, DSE, network, search, serve and thermal tables come from
the engine's exact integers, so they read as the reference's do,
character for character. Where the port's sections differ:

- the dry-run tables read the port's artifacts
  (``experiments/dryrun_torch/``, written by ``launch/dryrun.py``),
  which trace each cell on the meta device: the table shows the trace's
  host seconds (``lower_s``) where the reference shows compile seconds;
- the artifacts' roofline seconds and MFU are priced at the constants
  named in their ``hw`` (the reference's TPU pods): modelled from
  counts, not measured, and not the card's; the heading says so;
- the calibrate section times the port's kernels on ``device`` and its
  ``Backend:`` line names that device (on ``cuda``, the card's name and
  power limit as ``nvidia-smi`` gives them);
- ``main`` writes ``<section>_section.md`` and ``summary.json`` under
  ``out_dir`` (``experiments/report_torch/`` by default), never over the
  reference's files.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
ART = ROOT / "experiments" / "dryrun_torch"
OUT_DIR = ROOT / "experiments" / "report_torch"

SECTIONS = ("dryrun", "roofline", "dse", "network", "search", "calibrate", "serve",
            "thermal")

ARCH_ORDER = [
    "llama-3.2-vision-11b", "smollm-135m", "qwen2.5-3b", "qwen2-72b",
    "gemma3-1b", "whisper-medium", "zamba2-2.7b", "deepseek-moe-16b",
    "llama4-scout-17b-a16e", "xlstm-125m",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(strategy=None):
    arts = {}
    for p in sorted(ART.glob("*.json")):
        a = json.loads(p.read_text())
        if strategy and a.get("strategy") != strategy:
            continue
        arts[(a["arch"], a["shape"], a["mesh"], a.get("strategy", "dos"))] = a
    return arts


def _on(study, device):
    """``study`` with its analysis on ``device``."""
    return dataclasses.replace(
        study, analysis=dataclasses.replace(study.analysis, device=device))


def dryrun_section(arts):
    lines = [
        "### Per-cell dry-run results (strategy: dos = paper-faithful baseline; "
        "each cell traced on the meta device as rank 0)",
        "",
        "| arch | shape | mesh | trace s | GB/dev | GFLOPs/dev | collectives (counts) |",
        "|---|---|---|---|---|---|---|",
    ]
    ok_single = ok_multi = fail = 0
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            for mesh in ("pod16x16", "pod2x16x16"):
                a = arts.get((arch, shape, mesh, "dos"))
                if a is None:
                    continue
                if "error" in a:
                    fail += 1
                    lines.append(f"| {arch} | {shape} | {mesh} | **FAIL** | | | {a['error'][:60]} |")
                    continue
                if mesh == "pod16x16":
                    ok_single += 1
                else:
                    ok_multi += 1
                cost = a.get("cost_corrected", a["cost"])
                cc = a.get("collectives_corrected", a["collectives"])["counts"]
                cstr = " ".join(f"{k.split('-')[-1][:4]}:{v}" for k, v in sorted(cc.items()))
                lines.append(
                    f"| {arch} | {shape} | {mesh} | {a['lower_s']:.2f}s "
                    f"| {a['memory']['peak_per_device_gb']:.1f} "
                    f"| {cost.get('flops',0)/1e9:,.0f} | {cstr} |"
                )
    lines.insert(0, f"**{ok_single} single-pod + {ok_multi} multi-pod cells traced OK; {fail} failures.**\n")
    return "\n".join(lines) + "\n"


def roofline_section(arts, mac_budgets=(2**14, 2**16, 2**18), max_tiers=16,
                     cache=None, device=None):
    """Engine-backed roofline: the paper's Table-I workloads under a
    finite memory system (``BandwidthSpec.paper_default()``), next to
    the compute-bound prediction.

    Two declarative studies over the same (budget x tier) grid — one
    plain ``evaluate`` (the paper's peak-compute optimism) and one
    ``roofline`` (DRAM + SRAM reuse + TSV vertical links) — so the
    table shows, per (workload, budget): the compute-optimal tier
    count and speedup, the bandwidth-aware winner (which can differ),
    its bound class, and the stall share. The dry-run artifact table
    (when artifacts exist) follows as the scale-out counterpart.
    """
    from .core.bandwidth import BandwidthSpec
    from .core.dse import PAPER_WORKLOADS
    from .core.study import AnalysisSpec, SpaceSpec, Study, WorkloadSpec

    bw = BandwidthSpec.paper_default()
    names = list(PAPER_WORKLOADS)
    wl = [PAPER_WORKLOADS[n] for n in names]
    space = SpaceSpec(mac_budgets=mac_budgets, tiers=tuple(range(1, max_tiers + 1)))
    workload = WorkloadSpec(kind="gemms", gemms=wl)
    comp = Study(
        name="report-roofline-compute", workload=workload, space=space,
        analysis=AnalysisSpec(device=device),
    ).run(cache=cache).result
    res = Study(
        name="report-roofline-bw", workload=workload, space=space,
        analysis=AnalysisSpec(kind="roofline", bandwidth=bw, device=device),
    ).run(cache=cache).result

    W, B, T = len(wl), len(mac_budgets), max_tiers
    lines = [
        "### Engine roofline (Table-I workloads, dOS, TSV, "
        f"{bw.dram_gbs:.0f} GB/s DRAM, {bw.sram_kib_per_tier:.0f} KiB "
        "SRAM/tier)",
        "",
        "Compute-bound columns are the paper's model (Eqs. 1/2); the",
        "bandwidth-aware columns charge DRAM traffic under the SRAM reuse",
        "model and TSV vertical-link service time, and take the roofline",
        "`max(compute, memory, vlink)` per design point. The 2D baseline",
        "pays the same memory system, so `speedup` is honest on both sides.",
        "",
        "| workload | MACs | l* (compute) | speedup (compute) "
        "| l* (bw-aware) | speedup (bw-aware) | bound | stall % |",
        "|---|---|---|---|---|---|---|---|",
    ]

    def best_per(res_):
        cyc = np.where(res_.feasible, res_.cycles, np.inf).reshape(W, B, T)
        return np.argmin(cyc, axis=2)

    bc, bb = best_per(comp), best_per(res)
    for wi, nm in enumerate(names):
        for bi, b in enumerate(mac_budgets):
            pc, pb = bi * T + bc[wi, bi], bi * T + bb[wi, bi]
            stall = res.stall_cycles[wi, pb] / res.cycles[wi, pb]
            lines.append(
                f"| {nm} | 2^{int(np.log2(b))} | {bc[wi, bi] + 1} "
                f"| {comp.speedup[wi, pc]:.2f}x | {bb[wi, bi] + 1} "
                f"| {res.speedup[wi, pb]:.2f}x | **{res.bound[wi, pb]}** "
                f"| {100 * stall:.0f} |"
            )
    v = res.valid
    hist = {n: int(np.sum(v & (res.bound == n)))
            for n in ("compute", "memory", "vlink")}
    flips = int(np.sum(bc != bb))
    lines.append(
        f"\nBound mix over the {v.sum()}-point grid: {hist}; the "
        f"bandwidth-aware tier optimum differs from the compute-bound one "
        f"in {flips}/{W * B} (workload, budget) cells."
    )
    if arts:
        hw = next(iter(arts.values())).get("hw", {})
        model = hw.get("model", "the artifacts' hardware model")
        lines += [
            "",
            f"### Dry-run roofline (scale-out counterpart, priced for {model})",
            "",
            "The seconds, the dominant term and MFU are modelled from each "
            "meta trace's counts (FLOPs, bytes, collective wire bytes) at the "
            f"constants of {model}: not measured, and not the card's.",
            "",
        ]
        lines += _artifact_roofline_table(arts)
    return "\n".join(lines) + "\n"


def _artifact_roofline_table(arts):
    lines = [
        "| arch | shape | GB/dev | compute s | memory s (hlo / kernel) | collective s | dominant | MODEL/HLO | MFU | what would move the dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            a = arts.get((arch, shape, "pod16x16", "dos"))
            if a is None or "error" in a:
                continue
            r = a["roofline"]
            note = _note(a)
            lines.append(
                f"| {arch} | {shape} | {a['memory']['peak_per_device_gb']:.1f} "
                f"| {r['compute_s']:.3f} | {r['memory_s']:.3f} / {r['memory_s_kernel']:.3f} "
                f"| {r['collective_s']:.3f} | **{r['dominant']}** "
                f"| {r['useful_ratio']:.2f} | {r['mfu']*100:.2f}% | {note} |"
            )
    return lines


def _note(a):
    r = a["roofline"]
    d = r["dominant"]
    if d == "collective":
        return ("drop pure-dOS K-sharding where M*N/device is large "
                "(advisor: megatron/DP mix); reduce-scatter chaining")
    if d == "memory":
        if a["mode"] == "decode":
            return "cache layout/quantization; batch more requests per step"
        return "fuse optimizer+grad traffic; larger microbatches"
    return "near roofline: block-size/layout tuning only"


def dse_section(mac_budgets=(2**14, 2**16, 2**18), max_tiers=16, cache=None, device=None):
    """Study-backed DSE summary: per Table-I workload x MAC budget, the
    optimal tier count with its speedup, power, perf/area and T_max —
    one declarative ``evaluate`` study over the full grid (a single
    batched engine pass). Optima are restricted to the thermally
    feasible points (``res.feasible``); at the paper's scales nothing
    is masked (its Fig. 8 finding), but the constraint is structural,
    not assumed."""
    from .core.dse import PAPER_WORKLOADS
    from .core.study import AnalysisSpec, SpaceSpec, Study, WorkloadSpec

    names = list(PAPER_WORKLOADS)
    wl = [PAPER_WORKLOADS[n] for n in names]
    res = Study(
        name="report-dse",
        workload=WorkloadSpec(kind="gemms", gemms=wl),
        space=SpaceSpec(mac_budgets=mac_budgets,
                        tiers=tuple(range(1, max_tiers + 1))),
        analysis=AnalysisSpec(device=device),
    ).run(cache=cache).result
    W, B, T = len(wl), len(mac_budgets), max_tiers
    cyc = np.where(res.feasible, res.cycles, np.inf).reshape(W, B, T)
    best = np.argmin(cyc, axis=2)  # optimal feasible tier per (workload, budget)

    def pick(arr):
        return np.take_along_axis(arr.reshape(W, B, T), best[:, :, None], 2)[:, :, 0]

    speed = pick(res.speedup)
    power = pick(res.power_w)
    ans = pick(res.area_norm_speedup)
    tmax = pick(res.t_max_c)
    lines = [
        "### Engine DSE summary (Table-I workloads, dOS, TSV)",
        "",
        "| workload | MACs | l* | speedup | power W | perf/area | T_max C |",
        "|---|---|---|---|---|---|---|",
    ]
    for wi, name in enumerate(names):
        for bi, b in enumerate(mac_budgets):
            lines.append(
                f"| {name} | 2^{int(np.log2(b))} | {best[wi, bi] + 1} "
                f"| {speed[wi, bi]:.2f}x | {power[wi, bi]:.2f} "
                f"| {ans[wi, bi]:.2f}x | {tmax[wi, bi]:.0f} |"
            )
    masked = int(np.sum(res.valid & ~res.feasible))
    lines.append(
        f"\n{masked} of {res.valid.sum()} valid design points thermally "
        f"masked at the {res.grid.n_points}-point grid (junction limit)."
    )
    return "\n".join(lines) + "\n"


def network_section(shapes=("train_4k", "prefill_32k", "decode_32k"), cache=None,
                    device=None):
    """Network-level results: one declarative ``schedule`` study per
    model-zoo cell — lowered to its GEMM stream and scheduled through
    the engine, per-layer-optimal vs one fixed array design, end-to-end
    cycles/energy/EDP and 3D-vs-2D speedup."""
    from .configs import cells
    from .core.study import AnalysisSpec, Study, WorkloadSpec

    lines = [
        "### Network-level schedule (zoo -> lowering -> engine.schedule)",
        "",
        "Two mapping policies per network: `per-layer` (every GEMM on its",
        "own best feasible array — the DSE upper bound) and `fixed` (one",
        "rows x cols x tiers design serves all layers — the buildable",
        "accelerator). Speedup is vs the budget-matched optimized 2D",
        "baseline; designs over the junction limit are excluded.",
        "",
        "| network | shape | gemms (inv) | fixed design RxCxL | fixed cycles "
        "| fixed/opt | 3D-vs-2D | energy J | EDP Js | T_max C |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    live, _ = cells()
    for arch, shape in live:
        if shape not in shapes:
            continue
        rep = Study(
            name=f"report-network-{arch}-{shape}",
            workload=WorkloadSpec(kind="network", arch=arch, shape=shape),
            analysis=AnalysisSpec(kind="schedule", device=device),
        ).run(cache=cache).report
        fx, pl = rep.fixed, rep.per_layer
        r, c, l = (int(x) for x in np.asarray(fx.design).reshape(-1)[:3])
        lines.append(
            f"| {rep.arch} | {rep.shape} | {rep.n_gemms} ({rep.n_gemm_invocations}) "
            f"| {r}x{c}x{l} | {fx.total_cycles:.3e} "
            f"| {fx.total_cycles / pl.total_cycles:.3f} "
            f"| {fx.speedup_vs_2d:.2f}x | {fx.energy_j:.2e} "
            f"| {fx.edp_js:.2e} | {fx.t_max_c:.0f} |"
        )
    return "\n".join(lines) + "\n"


def search_section(cache=None, device=None):
    """Guided Pareto search demo: the example ``kind='search'`` study
    (budgets x tiers x dataflow x tech x DRAM x SRAM grades) priced to
    its cycles/energy frontier at a few-percent evaluated fraction."""
    from .core.study import Study

    out = _on(Study.example("search"), device).run(cache=cache)
    p = out.payload
    names = p["axis_names"]
    axes = " x ".join(f"{n}({len(p['axes'][n])})" for n in names)
    F = np.asarray(p["frontier_objectives"])
    idx = np.unique(np.linspace(0, len(F) - 1, 10).astype(int))
    lines = [
        "### Guided Pareto search (kind='search')",
        "",
        out.describe(),
        "",
        f"Space: {axes}; deterministic for the spec's seed, resumable "
        "per generation (`--cache`), multi-process (`--workers N`).",
        "",
        "| " + " | ".join(names) + " | " + " | ".join(p["objectives"]) + " |",
        "|" + "---|" * (len(names) + len(p["objectives"])),
    ]
    for i in idx:
        design = [f"{p['frontier_designs'][n][i]}" for n in names]
        objs = [f"{v:.3e}" for v in F[i]]
        lines.append("| " + " | ".join(design + objs) + " |")
    lines.append(
        f"\n{len(F)} frontier points; {len(idx)} shown (evenly sampled "
        f"along the cycles-sorted frontier); hypervolume "
        f"{p['hypervolume']:.4e} against ref {p['ref_point']}."
    )
    return "\n".join(lines) + "\n"


def backend_line(device) -> str:
    """Where the calibrate section measured: the device, and on a card
    its name and power limit as ``nvidia-smi`` gives them."""
    from ._device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return f"`{dev.type}`"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        import torch

        smi = f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return f"`cuda` ({smi})"


def calibrate_section(cache=None, device=None):
    """Measured-model calibration: the example ``kind='calibrate'``
    study (smoke grid — the full grid is ``preset='default'``) measured
    on ``device`` (the port's kernels on the card, their plain versions
    on the CPU) and fitted to the roofline; the table is per-shape
    measured vs modeled time. Wall times are device-local, so this
    section is honest about *where* it ran."""
    from .core.study import Study

    out = _on(Study.example("calibrate"), device).run(cache=cache)
    p = out.payload
    e = p["errors"]
    lines = [
        "### Calibrated roofline (kind='calibrate')",
        "",
        out.describe(),
        "",
        f"Backend: {backend_line(device)}. Fitted DRAM "
        f"{p['dram_gbs_fitted']:.2f} GB/s; holdout median relative error "
        f"{e['holdout_median_rel_err']:.1%} vs "
        f"{e['uncalibrated_holdout_median_rel_err']:.1%} for the "
        "uncalibrated nominal constants. The `artifact` in the study "
        "payload is a `CalibratedBandwidth` any other study accepts via "
        "`bandwidth=`.",
        "",
        "| shape | t measured | t model | rel err | GFLOP/s | GB/s |",
        "|---|---|---|---|---|---|",
    ]
    for r in p["rows"]:
        lines.append(
            f"| {r['label']} | {r['t_s']*1e3:.2f} ms | {r['pred_s']*1e3:.2f} ms "
            f"| {r['rel_err']:.1%} | {r['achieved_gflops']:.1f} "
            f"| {r['achieved_gbs']:.2f} |"
        )
    return "\n".join(lines) + "\n"


def serve_section(cache=None, device=None):
    """Serving-traffic study: the example ``kind='serve'`` study (a
    seeded mixed prefill/decode trace on a zoo model, priced per design
    point through the bandwidth-aware engine) reduced to the sustained
    serving metrics — the production-facing counterpart of the
    single-GEMM speedup tables."""
    from .core.study import Study

    out = _on(Study.example("serve"), device).run(cache=cache)
    p = out.payload
    pts = p["points"]
    t = out.study.analysis.serve.traffic
    lines = [
        "### Serving traffic (kind='serve')",
        "",
        out.describe(),
        "",
        f"Trace: {t.n_requests} requests at {t.arrival_rps:g} req/s "
        f"({p['trace']['tokens_in']} prompt + {p['trace']['tokens_out']} "
        f"generated tokens), max batch {t.max_batch}, {t.policy} batching, "
        f"chunked prefill at {t.chunk_prefill} tokens/step; each queue step "
        "is one vectorized engine call over all design points (seeded — "
        "re-runs and `--cache`/`--resume` are bit-identical).",
        "",
        "| design (RxCxL) | tech | feas | tok/s | TTFT p50/p99 [ms] "
        "| TPOT p50/p99 [ms] | E/token [mJ] | tok/s/W | stall |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for i in range(p["n_points"]):
        lines.append(
            f"| {pts['rows'][i]}x{pts['cols'][i]}x{pts['tiers'][i]} "
            f"| {pts['tech'][i]} | {'yes' if pts['feasible'][i] else 'no'} "
            f"| {pts['gen_tok_s'][i]:.0f} "
            f"| {pts['ttft_p50_s'][i]*1e3:.2f}/{pts['ttft_p99_s'][i]*1e3:.2f} "
            f"| {pts['tpot_p50_s'][i]*1e3:.2f}/{pts['tpot_p99_s'][i]*1e3:.2f} "
            f"| {pts['energy_per_token_j'][i]*1e3:.2f} "
            f"| {pts['tokens_per_s_per_w'][i]:.0f} "
            f"| {pts['stall_frac'][i]:.0%} |"
        )
    s = p["summary"]
    if s["win_3d_vs_2d"] is not None:
        lines.append(
            f"\nBest feasible 3D vs best feasible 2D on tokens/s/W: "
            f"{s['win_3d_vs_2d']:.2f}x."
        )
    return "\n".join(lines) + "\n"


def thermal_section(cache=None, device=None):
    """Transient thermal/DVFS: the example serve study re-run with
    ``thermal='transient'`` under a junction limit tightened to just
    above the coolest point's steady-state temperature, so every design
    throttles — the table shows what the worst-case steady gate hides:
    sustained tokens/s under the governor next to the peak the steady
    model advertises, with the governed temperature excursion and the
    throttled-state residency."""
    from .core.study import Study

    base = _on(Study.example("serve"), device)
    steady = base.run(cache=cache)
    t_hot = steady.payload["points"]["t_max_c"]
    limit = float(np.round(np.nanmin(t_hot) + 2.0, 1))
    tight = dataclasses.replace(
        base,
        name=base.name + "-transient",
        constraints=dataclasses.replace(
            base.constraints, thermal_limit_c=limit
        ),
        analysis=dataclasses.replace(base.analysis, thermal="transient"),
    )
    out = tight.run(cache=cache)
    p = out.payload
    pts = p["points"]
    dv = p["dvfs"]
    states = "/".join(f"{f:g}" for f in dv["freqs_ghz"])
    lines = [
        "### Transient thermal / DVFS (thermal='transient')",
        "",
        out.describe(),
        "",
        f"Junction limit tightened to {limit:.1f} degC (steady-state "
        f"coolest point + 2); governor states {states} GHz, throttle "
        f"margin {dv['throttle_margin_c']:g} degC, hysteresis "
        f"{dv['hysteresis_c']:g} degC. 'steady' marks the worst-case "
        "steady-state verdict at the fixed 1 GHz clock; every struck "
        "design still serves at the governed sustained rate.",
        "",
        "| design (RxCxL) | tech | steady | transient | peak tok/s "
        "| sustained tok/s | peak/sustained | T_max gov [degC] "
        "| top-state residency |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for i in range(p["n_points"]):
        resid_top = pts["dvfs_residency"][i][-1]
        lines.append(
            f"| {pts['rows'][i]}x{pts['cols'][i]}x{pts['tiers'][i]} "
            f"| {pts['tech'][i]} "
            f"| {'yes' if pts['feasible_steady'][i] else 'no'} "
            f"| {'yes' if pts['feasible'][i] else 'no'} "
            f"| {pts['peak_tok_s'][i]:.0f} "
            f"| {pts['gen_tok_s'][i]:.0f} "
            f"| {pts['peak_vs_sustained'][i]:.2f}x "
            f"| {pts['t_max_transient_c'][i]:.1f} "
            f"| {resid_top:.0%} |"
        )
    n_flip = int(np.sum(pts["feasible"] & ~pts["feasible_steady"]))
    lines.append(
        f"\n{n_flip} of {p['n_points']} designs are steady-infeasible at "
        "this limit yet serve within it under the governor — the "
        "peak-vs-sustained gap is the number the steady gate cannot see."
    )
    return "\n".join(lines) + "\n"


def summary_rows(arts) -> list[dict]:
    """The single-pod cells' roofline summary, worst MFU first."""
    rows = []
    for (arch, shape, mesh, strat), a in arts.items():
        if mesh != "pod16x16" or "error" in a:
            continue
        r = a["roofline"]
        rows.append({
            "arch": arch, "shape": shape, "strategy": strat,
            "dominant": r["dominant"], "step_s": r["step_s"],
            "mfu": r["mfu"], "collective_s": r["collective_s"],
            "compute_s": r["compute_s"],
            "mem_gb": a["memory"]["peak_per_device_gb"],
        })
    rows.sort(key=lambda x: x["mfu"])
    return rows


def main(sections=None, cache=None, device=None, out_dir=None):
    """Regenerate the requested sections (None = all) under ``out_dir``
    (``experiments/report_torch/`` by default) on ``device`` (``None``:
    the card). This is what ``python -m repro_torch report`` drives.
    ``cache`` (a directory path) makes the live studies chunk-cached:
    re-generating the report recomputes nothing that already ran — the
    sections come out bit-identical either way (chunking never changes
    results). Returns the paths written."""
    from ._device import resolve_device

    sections = set(sections) if sections else set(SECTIONS)
    unknown = sections - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown report sections {sorted(unknown)}; have {list(SECTIONS)}")
    resolve_device(device)  # no card and no device="cpu": raise before writing anything
    if cache is not None:
        from .core.cache import ResultCache

        cache = cache if isinstance(cache, ResultCache) else ResultCache(cache)
    out = pathlib.Path(out_dir or OUT_DIR)
    out.mkdir(parents=True, exist_ok=True)
    arts = load() if sections & {"dryrun", "roofline"} else {}
    texts = {
        "dryrun": lambda: dryrun_section(arts),
        "roofline": lambda: roofline_section(arts, cache=cache, device=device),
        "dse": lambda: dse_section(cache=cache, device=device),
        "network": lambda: network_section(cache=cache, device=device),
        "search": lambda: search_section(cache=cache, device=device),
        "calibrate": lambda: calibrate_section(cache=cache, device=device),
        "serve": lambda: serve_section(cache=cache, device=device),
        "thermal": lambda: thermal_section(cache=cache, device=device),
    }
    written = []
    for name in SECTIONS:
        if name in sections:
            path = out / f"{name}_section.md"
            path.write_text(texts[name]())
            written.append(path)
    if "roofline" not in sections:
        return written
    # machine-readable summary for the hillclimb
    rows = summary_rows(arts)
    path = out / "summary.json"
    path.write_text(json.dumps(rows, indent=1))
    written.append(path)
    print(f"{len(rows)} single-pod cells summarized; worst MFU:")
    for r in rows[:6]:
        print(f"  {r['arch']}/{r['shape']}/{r['strategy']}: mfu={r['mfu']*100:.2f}% "
              f"dom={r['dominant']} step={r['step_s']*1e3:.1f}ms mem={r['mem_gb']}GB")
    return written
