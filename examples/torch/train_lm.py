"""End-to-end training on the PyTorch port: train SmolLM-135M (the real
config) on the synthetic pipeline for a few hundred steps with
checkpointing.

Run:  PYTHONPATH=src python examples/torch/train_lm.py --steps 200
(--smoke uses the reduced config; --device cpu runs the kernels' plain
versions on the CPU.)
"""

import argparse
import os
import tempfile

from repro_torch.configs import REGISTRY, reduced
from repro_torch.launch.train import train_loop
from repro_torch.optim import OptConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--strategy", default="dos")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = REGISTRY["smollm-135m"]
    if args.smoke:
        cfg = reduced(cfg)
    print(f"training {cfg.name} ({cfg.n_layers}L d{cfg.d_model}) "
          f"for {args.steps} steps")
    _, losses, wd = train_loop(
        cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        strategy=args.strategy, ckpt_dir=args.ckpt_dir, ckpt_every=50,
        log_every=10,
        opt_cfg=OptConfig(lr=6e-4, warmup_steps=30, total_steps=args.steps),
        device=args.device,
    )
    k = max(len(losses) // 10, 1)
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    print(f"loss: {first:.3f} -> {last:.3f} over {len(losses)} steps "
          f"({len(wd.slow_steps)} straggler steps)")


if __name__ == "__main__":
    main()
