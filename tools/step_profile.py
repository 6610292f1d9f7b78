"""Decode and train steps of several trees of the port, on one card, in turns.

For each tree: the device busy time and device ops per decode step of
llama-3.2-vision-11b (two of its eight groups) and whisper-medium, and
the plain-op time (device time outside the port's kernels) of one train
step of the vision model (one group), deepseek-moe-16b (four layers) and
zamba2-2.7b, each taken by that tree's own ``chip_smoke.py`` functions
(``serve_decode_state`` and ``phase_profile``; ``phase_train_cross``,
``phase_train_path`` and their profiles), so each tree is held to its own
gates. Every tree runs in a process of its own, in the order given, so
that two trees can be compared in one call as A B B A:

    python3 tools/step_profile.py PARENT . . PARENT --json steps.json

The last line of the output is a JSON summary by run; ``--json`` writes
every number the runs took.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

DECODE_STEPS = 8  # host-clock steps for each decode step's p50


def one(tree: str) -> dict:
    """The measurements of one tree, in this process."""
    path = os.path.join(os.path.abspath(tree), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_tree", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts the tree's src first on sys.path
    import torch

    cs.phase_device()
    cs.phase_build()
    out = {"tree": tree, "decode_p50_s": {}}
    for arch in (cs.VLM, cs.WHISPER):
        steps = cs.PROFILE_STEPS
        cs.PROFILE_STEPS = steps + DECODE_STEPS  # room in the cache for the timed steps
        model, params, cache, tok = cs.serve_decode_state(arch)
        cs.PROFILE_STEPS = steps
        times = []
        with torch.no_grad():
            for _ in range(DECODE_STEPS):
                t0 = time.perf_counter()
                logits, cache = model.decode(params, cache, {"token": tok})
                tok = logits.argmax(dim=-1)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            p50 = sorted(times)[len(times) // 2]
            out["decode_p50_s"][arch] = p50
            cs.phase_profile(arch, model, params, cache, tok, p50)
        del model, params, cache
        torch.cuda.empty_cache()
    _, state, p50 = cs.phase_train_cross(cs.VLM)
    cs.phase_train_cross_profile(cs.VLM, state, p50)
    del state
    torch.cuda.empty_cache()
    _, state, p50 = cs.phase_train_path(cs.MOE)
    cs.phase_train_moe_profile(state, p50)
    del state
    torch.cuda.empty_cache()
    _, state, p50 = cs.phase_train_path(cs.HYBRID)
    cs.phase_train_hybrid_profile(state, p50)
    out["profile"] = cs.RESULTS["profile"]
    out["device"] = cs.RESULTS["device"]
    return out


def _summary(run: dict) -> dict:
    prof = run["profile"]
    row = {}
    for key, p in prof.items():
        if not p:
            continue
        if "busy_ms_per_step" in p:
            row[f"{key} decode"] = {"busy_ms": p["busy_ms_per_step"],
                                    "device_ops": p["device_ops_per_step"],
                                    "idle_share": p["idle_share"]}
        elif "plain_ms" in p:
            row[key] = {"busy_ms": p["busy_ms"], "plain_ms": p["plain_ms"],
                        "device_ops": p["device_ops"], "kernel_ms": p["kernel_ms"]}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="checkouts of the port, in the order to run them")
    ap.add_argument("--one", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--json", metavar="PATH", help="write every run's numbers as JSON")
    args = ap.parse_args(argv)
    if args.one:
        print("STEP_PROFILE " + json.dumps(one(args.one)), flush=True)
        return 0
    runs = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout[-6000:])
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-6000:])
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        line = next(s for s in proc.stdout.splitlines() if s.startswith("STEP_PROFILE "))
        runs.append(json.loads(line[len("STEP_PROFILE "):]))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(runs, f, indent=1)
    print(json.dumps([{"tree": r["tree"], **_summary(r)} for r in runs]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
