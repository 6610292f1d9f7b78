"""The dry-run's artifacts as a markdown table, one row per live cell.

    PYTHONPATH=src python tools/dryrun_table.py [ART_DIR]

Reads ``experiments/dryrun_torch/*.json`` (``python -m
repro_torch.launch.dryrun --both-meshes`` writes them) and prints, per
(arch, shape): GB per rank on (16, 16) and (2, 16, 16), FLOPs per rank,
the collectives rank 0 issues by op, kernel launches, and the host
seconds of each trace. Then the cells whose peak per rank exceeds one
H100's 80 GB, and any failed cell.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPS = (("all-reduce", "AR"), ("all-gather", "AG"), ("reduce-scatter", "RS"))
H100_GB = 80e9 / 2**30  # 80 GB of HBM, in the artifacts' GiB


def main(art_dir=None) -> int:
    art_dir = pathlib.Path(art_dir or ROOT / "experiments" / "dryrun_torch")
    arts = [json.loads(p.read_text()) for p in sorted(art_dir.glob("*.json"))]
    by = {(a["arch"], a["shape"], a["mesh"]): a for a in arts}
    failed = [a for a in arts if "error" in a]
    print("| arch | shape | GB/rank 16x16 | GB/rank 2x16x16 | FLOPs/rank 16x16 | collectives "
          "16x16 (AR/AG/RS) | launches | trace s (16x16, 2x16x16) |")
    print("|---|---|---|---|---|---|---|---|")
    for arch, shape in sorted({(a, s) for a, s, _ in by}):
        one, two = by.get((arch, shape, "pod16x16")), by.get((arch, shape, "pod2x16x16"))
        if one is None or two is None or "error" in one or "error" in two:
            continue
        counts = one["collectives"]["counts"]
        launches = sum(n for v in one["launches"].values() for n in v.values())
        print(f"| {arch} | {shape} | {one['memory']['peak_per_device_gb']:.3f} | "
              f"{two['memory']['peak_per_device_gb']:.3f} | {one['cost']['flops']:.3e} | "
              + "/".join(str(counts.get(op, 0)) for op, _ in OPS)
              + f" | {launches} | {one['lower_s']}, {two['lower_s']} |")
    over = sorted(f"{a['arch']} {a['shape']} {a['mesh']} ({a['memory']['peak_per_device_gb']} GB)"
                  for a in arts if "error" not in a
                  and a["memory"]["peak_per_device_gb"] > H100_GB)
    print(f"\nabove one H100's 80 GB per rank: {', '.join(over) or 'none'}")
    print(f"cells: {len(arts)}, failed: {len(failed)}"
          + "".join(f"\n  {a['arch']} {a['shape']} {a['mesh']}: {a['error']}" for a in failed))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main(*sys.argv[1:]))
