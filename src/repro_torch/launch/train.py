"""Training launcher: the fault-tolerant loop with checkpoints, on one card.

    python -m repro_torch.launch.train --arch smollm-135m --steps 30 --batch 8 --seq 512
    python -m repro_torch.launch.train --arch zamba2-2.7b --steps 30 --batch 8 --seq 512
    python -m repro_torch.launch.train --arch xlstm-125m --steps 30 --batch 8 --seq 512
    python -m repro_torch.launch.train --arch deepseek-moe-16b --layers 4 --steps 30 --batch 8 --seq 512
    python -m repro_torch.launch.train --smoke --device cpu --steps 3 --json

The same loop as the JAX package's: a deterministic restart-safe data
pipeline, AdamW with warmup and cosine decay, async checkpoints every
``ckpt_every`` steps and a final one, restart from the latest checkpoint
on a failure (``run_with_restarts``, with injectable faults), and the
straggler watchdog. One departure: a checkpoint ``step_N`` holds the
state after N steps, and a restart from it runs step N next, so the
resumed run repeats the uninterrupted one. The reference saves at step N
the state after N + 1 steps and resumes at step N, repeating step N's
batch (ROADMAP queue 3); the files are the same. Weights are drawn from ``seed`` on the CPU in the
config's ``param_dtype`` (f32 masters) and moved to the device; each GEMM
casts them to the compute dtype. Every step ends with a device
synchronize, so the watchdog's step times are the device's.

Runs on the card unless ``device="cpu"``; raises without one. The
dense, MoE, hybrid and SSM (xLSTM) families train here under every
strategy on any (data, model) mesh. Under ``torchrun`` the CLI lays the
world out as a (1, WORLD_SIZE) mesh (``launch.mesh.cli_mesh``):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --strategy dos --steps 30
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch zamba2-2.7b --steps 30

The vision (vlm) and encoder-decoder (encdec) families raise
(``check_trainable``): the loop feeds
``SyntheticLM``'s tokens and labels only, as the reference's does, and
the reference's loop fails on them too; they train through
``launch.steps.make_train_step`` with ``image_embeds`` / ``enc_frames``
in the batch. ``--layers N`` cuts the config's depth to N layers at full
width (``cut_depth``; a vision model keeps whole groups of
``cross_every`` layers): deepseek-moe-16b's f32 masters, gradients and
AdamW moments take 16 bytes a parameter (270 GB at full depth), so one
card trains it at 4 layers. The step donates the state it is given, as the
reference's jitted step does (``donate_argnums``): AdamW writes the new
parameters and moments into the old ones' memory, so a step holds
params, moments and gradients once each (zamba2-2.7b: ~39 GB in f32,
not ~68).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from .._device import device_info, resolve_device
from ..checkpoint import checkpointer
from ..configs import get_config, reduced
from ..data import DataConfig, SyntheticLM
from ..kernels import launch_counts
from ..models import build
from ..models.zoo import MODEL_INPUTS, spans_ranks
from ..optim import OptConfig, init_opt_state
from ..parallel.axes import STRATEGIES, ShardingRules, param_sharding, use_rules
from ..parallel.plan import gather_tree, shard_place
from ..runtime import FaultInjector, StragglerWatchdog, elastic_restore, run_with_restarts
from .mesh import cli_mesh, is_first_rank, make_test_mesh
from .steps import make_train_step

__all__ = ["check_trainable", "cut_depth", "train_loop", "main"]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_trainable(cfg):
    """Raise unless ``train_loop`` can train ``cfg``. It feeds tokens and
    labels only, as the reference's ``train_loop`` does; the vision and
    encoder-decoder models need image embeddings or encoder frames too."""
    if cfg.family in MODEL_INPUTS:
        extra = MODEL_INPUTS[cfg.family][0]
        raise NotImplementedError(
            f"train_loop feeds tokens and labels only, as the reference's train_loop does, "
            f"and family {cfg.family!r} ({cfg.name}) also needs {extra!r}: train it through "
            f"launch.steps.make_train_step with {extra!r} in the batch"
        )


def cut_depth(cfg, n_layers: int):
    """``cfg`` at full width with its depth cut to ``n_layers``. A vision
    model keeps whole groups (``cross_every - 1`` self layers and one
    cross layer), so ``n_layers`` must be a multiple of ``cross_every``."""
    if cfg.family == "vlm" and n_layers % cfg.cross_every:
        raise ValueError(f"{cfg.name}: {n_layers} layers is not a multiple of cross_every "
                         f"{cfg.cross_every}")
    return dataclasses.replace(cfg, n_layers=n_layers)


def train_loop(
    cfg,
    *,
    steps: int = 100,
    global_batch: int = 8,
    seq_len: int = 128,
    strategy: str = "dos",
    mesh_shape=(1, 1),
    ckpt_dir: str | None = None,
    ckpt_every: int = 20,
    microbatches: int = 1,
    fault_injector: FaultInjector | None = None,
    log_every: int = 10,
    opt_cfg: OptConfig | None = None,
    seed: int = 0,
    device=None,
):
    """Train ``cfg`` for ``steps`` steps. Returns ``(state, losses,
    watchdog)``: state ``{"params", "opt"}`` (this rank's shards), the
    loss of every step run (a restart repeats the steps after its
    checkpoint), and the watchdog with the step times. ``strategy`` (dos,
    megatron, zero, auto) and ``mesh_shape`` (data, model) are the
    reference's: on a mesh of more than one rank (the default process
    group's, ``launch.mesh``) each rank holds its shards of the f32
    masters and AdamW moments under the rules with FSDP on, and takes
    its part of each step's global batch. Checkpoints hold full arrays
    (gathered; rank 0 writes them), so a run restores onto any mesh
    (``elastic_restore``)."""
    dev = resolve_device(device)
    rules = ShardingRules(make_test_mesh(*mesh_shape), strategy=strategy, fsdp=True)
    multi = spans_ranks(cfg, rules)
    check_trainable(cfg)
    model = build(cfg, device=dev)
    opt_cfg = opt_cfg or OptConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    # every rank makes the global batch (as one process does) and keeps its rows
    data = SyntheticLM(DataConfig(cfg.vocab, seq_len, global_batch, seed=seed),
                       process_index=0, process_count=1)
    step_fn = make_train_step(model, opt_cfg, remat=True, microbatches=microbatches)
    specs = param_sharding(model.defs, rules) if multi else None
    state_specs = {"params": specs, "opt": {"m": specs, "v": specs, "step": ()}}

    losses = []
    watchdog = StragglerWatchdog()

    def make_state(resume_step):
        place = shard_place(specs, rules.mesh) if multi else None
        params = model.init(torch.Generator().manual_seed(seed), place=place)
        opt = init_opt_state(params)
        if resume_step is not None and ckpt_dir:
            state = elastic_restore(ckpt_dir, resume_step, {"params": params, "opt": opt}, dev,
                                    specs=state_specs if multi else None, mesh=rules.mesh)
            params, opt = state["params"], state["opt"]
        return {"params": params, "opt": opt}

    def save(step, state, wait):
        """One rank: ``save_async`` but for the last. A mesh: the full arrays
        gathered, rank 0 writing them, every rank waiting until they are
        on disk, so that none looks for a step that is half written."""
        if not multi:
            (checkpointer.save if wait else checkpointer.save_async)(ckpt_dir, step, state)
            return
        full = gather_tree(state, state_specs, rules.mesh)
        if dist.get_rank() == 0:
            checkpointer.save(ckpt_dir, step, full)
        dist.barrier()

    def run(state, start_step):
        params, opt = state["params"], state["opt"]
        for step in range(start_step, steps):
            if fault_injector is not None:
                fault_injector.maybe_fail(step)
            watchdog.start_step()
            batch = {k: torch.from_numpy(x).to(dev) for k, x in data.batch(step).items()}
            with use_rules(rules if multi else None):
                params, opt, loss = step_fn(params, opt, batch)
            _sync(dev)
            watchdog.end_step(step)
            losses.append(float(loss))
            if log_every and step % log_every == 0 and is_first_rank():
                print(f"step {step:5d} loss {float(loss):.4f}")
            done = step + 1  # a checkpoint is named by the steps it has taken
            if ckpt_dir and done % ckpt_every == 0 and done < steps:
                save(done, {"params": params, "opt": opt}, wait=False)
        if ckpt_dir:
            save(steps, {"params": params, "opt": opt}, wait=True)
        return {"params": params, "opt": opt}

    if ckpt_dir:
        state = run_with_restarts(make_state, run, ckpt_dir=ckpt_dir)
        checkpointer.wait_for_saves()
    else:
        state = run(make_state(None), 0)
    return state, losses, watchdog


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers (full width)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--strategy", default="dos", choices=STRATEGIES,
                    help="the reference's sharding rules")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true", help="emit the machine-readable summary")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if args.layers:
        cfg = cut_depth(cfg, args.layers)
    dev, mesh_shape = cli_mesh(args.device)
    c0 = launch_counts()
    t0 = time.time()
    _, losses, wd = train_loop(
        cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        strategy=args.strategy, mesh_shape=mesh_shape, ckpt_dir=args.ckpt_dir,
        microbatches=args.microbatches, log_every=0 if args.json else 10,
        opt_cfg=OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
        device=dev,
    )
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    if not is_first_rank():
        return
    if args.json:
        step_s = np.asarray(wd.times)
        c1 = launch_counts()
        print(json.dumps({
            "arch": args.arch, "steps": args.steps, "batch": args.batch, "seq": args.seq,
            "microbatches": args.microbatches, "wall_s": dt, "tok_s": toks / dt,
            "step_p50_s": float(np.percentile(step_s, 50)),
            "step_p99_s": float(np.percentile(step_s, 99)),
            "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
            "slow_steps": wd.slow_steps, "launches": {k: c1[k] - c0[k] for k in c1},
            "device": device_info(dev),
        }, indent=1))
        return
    print(
        f"done: {args.steps} steps in {dt:.1f}s ({toks/dt:.0f} tok/s) on "
        f"{device_info(dev)['kind']}; loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
        f"slow steps: {len(wd.slow_steps)}"
    )


if __name__ == "__main__":
    main()
