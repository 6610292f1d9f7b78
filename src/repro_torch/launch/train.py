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

Runs on the card unless ``device="cpu"``; raises without one. One device
only: a ``mesh_shape`` other than (1, 1), or a ``strategy`` other than
``"dos"``, is ROADMAP queue 1 item 10. The dense, MoE, hybrid and SSM
(xLSTM) families train here. The vision (vlm) and encoder-decoder
(encdec) families raise (``check_trainable``): the loop feeds
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

from .._device import device_info, resolve_device
from ..checkpoint import checkpointer
from ..configs import get_config, reduced
from ..data import DataConfig, SyntheticLM
from ..kernels import launch_counts
from ..models import build
from ..models.zoo import MODEL_INPUTS
from ..optim import OptConfig, init_opt_state
from ..runtime import FaultInjector, StragglerWatchdog, elastic_restore, run_with_restarts
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
    watchdog)``: state ``{"params", "opt"}``, the loss of every step run
    (a restart repeats the steps after its checkpoint), and the watchdog
    with the step times. ``strategy`` names the reference's sharding
    rules; only its default, ``"dos"``, is taken."""
    dev = resolve_device(device)
    if tuple(mesh_shape) != (1, 1):
        raise NotImplementedError(
            "multi-device training is not ported yet (ROADMAP queue 1 item 10)"
        )
    if strategy != "dos":
        raise NotImplementedError(
            f"sharding strategy {strategy!r} is not ported yet (ROADMAP queue 1 item 10)"
        )
    check_trainable(cfg)
    model = build(cfg, device=dev)
    opt_cfg = opt_cfg or OptConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    data = SyntheticLM(DataConfig(cfg.vocab, seq_len, global_batch, seed=seed))
    step_fn = make_train_step(model, opt_cfg, remat=True, microbatches=microbatches)

    losses = []
    watchdog = StragglerWatchdog()

    def make_state(resume_step):
        params = model.init(torch.Generator().manual_seed(seed))
        opt = init_opt_state(params)
        if resume_step is not None and ckpt_dir:
            state = elastic_restore(ckpt_dir, resume_step, {"params": params, "opt": opt}, dev)
            params, opt = state["params"], state["opt"]
        return {"params": params, "opt": opt}

    def run(state, start_step):
        params, opt = state["params"], state["opt"]
        for step in range(start_step, steps):
            if fault_injector is not None:
                fault_injector.maybe_fail(step)
            watchdog.start_step()
            batch = {k: torch.from_numpy(x).to(dev) for k, x in data.batch(step).items()}
            params, opt, loss = step_fn(params, opt, batch)
            _sync(dev)
            watchdog.end_step(step)
            losses.append(float(loss))
            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {float(loss):.4f}")
            done = step + 1  # a checkpoint is named by the steps it has taken
            if ckpt_dir and done % ckpt_every == 0 and done < steps:
                checkpointer.save_async(ckpt_dir, done, {"params": params, "opt": opt})
        if ckpt_dir:
            checkpointer.save(ckpt_dir, steps, {"params": params, "opt": opt})
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
    ap.add_argument("--strategy", default="dos",
                    help="the reference's sharding rules; only dos is ported")
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
    dev = resolve_device(args.device)
    c0 = launch_counts()
    t0 = time.time()
    _, losses, wd = train_loop(
        cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        strategy=args.strategy, ckpt_dir=args.ckpt_dir,
        microbatches=args.microbatches, log_every=0 if args.json else 10,
        opt_cfg=OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
        device=dev,
    )
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
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
