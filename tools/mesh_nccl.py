#!/usr/bin/env python3
"""Serve and train the dense family over a (data, model) mesh of cards.

    python3 tools/mesh_nccl.py [--json PATH] [--world 4]

Needs ``--world`` CUDA cards on one host (4 by default). Builds the
kernels once, then starts one process per card, each given ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` (localhost) and a free
``MASTER_PORT``, as ``torchrun`` gives them. Each rank first serves and
trains on its card alone (no process group): those are the one-card
tokens and losses. Then the ranks join one NCCL group and run, through
the entry points a user calls:

- ``serve_loop`` for smollm-135m at full size (batch 4, prompt 128, 32
  greedy tokens, bf16) at (2, 2), (1, 4) and (4, 1) (world 4) under
  ``dos``, ``megatron``, ``zero`` and ``auto``: the tokens against the
  one-card tokens (a bf16 projection's partial sums meet in another
  order on a mesh, so a near tie may pick another token: the count of
  equal tokens is reported beside the first that differs), the prefill
  time, the decode step's p50 and the launches of the ranks' kernels;
- the same in f32 (``compute_dtype="float32"``) under ``dos`` and
  ``megatron`` at (1, 4), whose tokens must equal the one card's;
- ``train_loop`` for smollm-135m at 8 x 512 for 3 steps at (2, 2) under
  ``dos``, ``megatron`` and ``zero``: the losses against the one card's
  (f32 masters, bf16 GEMMs), reported as the largest gap.

Rank 0 prints one line per run and the ``nvidia-smi`` line, and writes
everything to ``--json``. Every rank process is killed if one fails or
the run outlives ``--timeout`` seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "smollm-135m"
BATCH, PROMPT, GEN = 4, 128, 32
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 3
STRATEGIES = ("dos", "megatron", "zero", "auto")
TRAIN_STRATEGIES = ("dos", "megatron", "zero")


def meshes(world: int):
    out = [(1, world), (world, 1)]
    if world == 4:
        out.insert(0, (2, 2))
    return out


def rank_main(out_path: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.launch.serve import serve_loop
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import OptConfig

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    cfgs = {"bfloat16": get_config(ARCH),
            "float32": dataclasses.replace(get_config(ARCH), compute_dtype="float32")}
    opt = OptConfig(lr=1e-3, warmup_steps=20, total_steps=TRAIN_STEPS)

    def serve(dtype, mesh_shape=(1, 1), strategy="dos"):
        return serve_loop(cfgs[dtype], batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN,
                          strategy=strategy, mesh_shape=mesh_shape, device=dev)

    def train(mesh_shape=(1, 1), strategy="dos"):
        return train_loop(get_config(ARCH), steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                          seq_len=TRAIN_SEQ, seed=0, log_every=0, strategy=strategy,
                          mesh_shape=mesh_shape, opt_cfg=opt, device=dev)[1]

    solo = {dtype: serve(dtype) for dtype in cfgs}
    solo_losses = train()
    out = {"one_card": {dtype: {"step_p50_s": r["step_p50_s"], "prefill_s": r["prefill_s"]}
                        for dtype, r in solo.items()},
           "one_card_losses": solo_losses, "serve": [], "train": []}

    def log(text):
        if rank == 0:
            print(text, flush=True)

    log(f"[one card] serve bf16 step p50 {solo['bfloat16']['step_p50_s']*1e3:.3f} ms, f32 "
        f"{solo['float32']['step_p50_s']*1e3:.3f} ms; train losses {solo_losses}")
    init_distributed("cuda")
    ok = True
    try:
        runs = [("bfloat16", m, s) for m in meshes(world) for s in STRATEGIES]
        runs += [("float32", (1, world), s) for s in ("dos", "megatron")]
        for dtype, mesh_shape, strategy in runs:
            t0 = time.perf_counter()
            r = serve(dtype, mesh_shape, strategy)
            got, want = r["generated"].cpu(), solo[dtype]["generated"].cpu()
            eq = got == want
            first = None if bool(eq.all()) else int((~eq).any(dim=0).nonzero()[0])
            row = {"dtype": dtype, "mesh": mesh_shape, "strategy": strategy,
                   "equal_tokens": int(eq.sum()), "tokens": eq.numel(),
                   "first_differing_position": first, "prefill_s": r["prefill_s"],
                   "step_p50_s": r["step_p50_s"], "launches": r["launches"],
                   "wall_s": time.perf_counter() - t0}
            out["serve"].append(row)
            log(f"[mesh] serve {dtype} {mesh_shape} {strategy}: {row['equal_tokens']}/"
                f"{row['tokens']} tokens equal the one card's (first differing position "
                f"{first}); prefill {r['prefill_s']*1e3:.2f} ms, step p50 "
                f"{r['step_p50_s']*1e3:.3f} ms; launches {r['launches']}")
            if dtype == "float32" and first is not None:
                ok = False
        for strategy in TRAIN_STRATEGIES:
            losses = train((2, world // 2), strategy)
            gap = max(abs(a - b) for a, b in zip(losses, solo_losses))
            out["train"].append({"mesh": (2, world // 2), "strategy": strategy,
                                 "losses": losses, "max_gap": gap})
            log(f"[mesh] train (2, {world // 2}) {strategy}: losses {losses}, largest gap to "
                f"the one card's {gap:.3g}")
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    if not ok:
        raise SystemExit("f32 tokens on the mesh differ from the one card's")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=os.path.join(ROOT, "chiprun_out", "mesh_nccl.json"))
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=780.0)
    args = ap.parse_args(argv)
    if os.environ.get("RANK") is not None:
        rank_main(args.json)
        return 0
    import torch

    from repro_torch.kernels import _build

    if torch.cuda.device_count() < args.world:
        print(f"needs {args.world} cards, found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: "
          f"{'; '.join(smi.stdout.strip().splitlines())}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(args.world), PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--json", args.json],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT)
             for r in range(args.world)]
    deadline = time.monotonic() + args.timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    print(f"[mesh] ranks' exit codes {[p.returncode for p in procs]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
