#!/usr/bin/env python3
"""Time smollm-135m's serving decode step in two source trees, and with and
without a live NCCL process group, on one GPU.

    python3 tools/serve_ab.py [--json PATH] [--reps N] TREE [TREE ...]

Each TREE is a checkout of the repo (its ``src/`` holds ``repro_torch``);
they run in the order given, one process each (give parent, change,
change, parent to see the drift between calls). In each process
``serve_loop`` serves smollm-135m at phase 3's size (batch 4, prompt 128,
32 greedy tokens, bf16) ``--reps`` times with no process group, then as
many times in an NCCL group of one rank (made by ``torch.distributed``
itself, so a tree without a mesh module takes it too; nothing is sharded
and no collective is issued), then as many times again with the group
destroyed. Each run prints its decode step's p50 and whether its tokens
equal the first run's. Needs a CUDA card and nvcc; each tree builds its
kernels on first use.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

_CHILD = r"""
import json, tempfile
import torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve_loop
torch.backends.cuda.matmul.allow_tf32 = False
cfg, out = get_config("smollm-135m"), []
def serve(phase):
    r = serve_loop(cfg, batch=4, prompt_len=128, gen_tokens=32, device="cuda")
    out.append({"phase": phase, "step_p50_s": r["step_p50_s"], "prefill_s": r["prefill_s"],
                "tokens": r["generated"].cpu().tolist()})
for _ in range(REPS):
    serve("no group")
dist.init_process_group("nccl", init_method=f"file://{tempfile.mkdtemp()}/pg", rank=0,
                        world_size=1)
for _ in range(REPS):
    serve("NCCL group of 1")
dist.destroy_process_group()
for _ in range(REPS):
    serve("no group again")
print("RUNS " + json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[device] nvidia-smi: {smi.stdout.strip()}", flush=True)
    results, first = [], None
    for tree in args.trees:
        src = os.path.join(os.path.abspath(tree), "src")
        p = subprocess.run([sys.executable, "-c", _CHILD.replace("REPS", str(args.reps))],
                           env=dict(os.environ, PYTHONPATH=src), capture_output=True, text=True,
                           cwd=tempfile.gettempdir(), timeout=900)
        line = next((ln for ln in p.stdout.splitlines() if ln.startswith("RUNS ")), None)
        if p.returncode != 0 or line is None:
            print(f"[ab] {tree}: exit {p.returncode}\n{p.stderr[-4000:]}", flush=True)
            return 1
        runs = json.loads(line[len("RUNS "):])
        first = first or runs[0]["tokens"]
        for r in runs:
            print(f"[ab] {tree}: {r['phase']}: step p50 {r['step_p50_s']*1e3:.3f} ms, prefill "
                  f"{r['prefill_s']*1e3:.2f} ms, tokens equal the first run's: "
                  f"{r.pop('tokens') == first}", flush=True)
        results.append({"tree": tree, "runs": runs})
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"nvidia_smi": smi.stdout.strip(), "trees": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
