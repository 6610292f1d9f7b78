#!/usr/bin/env python3
"""Train the one-group vision model, and a dense model of its width, for
30 steps at two learning rates on one GPU.

    python3 tools/vlm_lr_probe.py

``chip_smoke.py`` phase 16 trains llama-3.2-vision-11b at full width cut
to one group (4 self-attention layers and the gated cross layer) through
``make_train_step``, 8 x 512 ``SyntheticLM`` tokens a step, AdamW with
20 warmup steps. This prints the 30 losses of that run at learning rate
1e-3 (the other training paths') with each step's image embeddings drawn
from the step, as the phase draws them, and with one set for every step;
at 3e-4; and those of the same config made a dense decoder (the 4 self
layers alone, no images) at 1e-3 and 3e-4, each from the same weights
(drawn on the card from seed 0), and the gate after the last step. It
shows whether the cross layer, the images or the width decides whether
the loss falls. Needs a CUDA card, nvcc and ``chip_smoke.py`` beside this
directory.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from repro_torch.models.params import map_tree  # noqa: E402

STEPS = 30


def run(cfg, lr, images, params0, tag):
    """``STEPS`` train steps of ``cfg`` from a copy of ``params0``."""
    model = cs.build(cfg, "cuda")
    step_fn = cs.make_train_step(model, cs.OptConfig(lr=lr, warmup_steps=20, total_steps=STEPS),
                                 remat=True)
    data = cs.SyntheticLM(cs.DataConfig(cfg.vocab, cs.TRAIN_SEQ, cs.TRAIN_BATCH, seed=0))
    params = map_tree(torch.clone, params0)
    opt = cs.init_opt_state(params)
    losses = []
    for step in range(STEPS):
        batch = {k: torch.from_numpy(x).to("cuda") for k, x in data.batch(step).items()}
        if cfg.family == "vlm":
            batch.update(cs.train_inputs(cfg, cs.TRAIN_BATCH, step if images == "per step" else 0))
        params, opt, loss = step_fn(params, opt, batch)
        losses.append(float(loss))
    gate = params["cross_layers"]["gate"].flatten().tolist() if cfg.family == "vlm" else None
    print(f"[probe] {tag}: {' '.join(f'{x:.3f}' for x in losses)}"
          + (f"; gate {gate}" if gate else ""), flush=True)


def main():
    cs.phase_device()
    cs.phase_build()
    cfg = cs.cross_train_cfg(cs.VLM)
    p0 = cs.build(cfg, "cuda").init(torch.Generator(device="cuda").manual_seed(0))
    run(cfg, 1e-3, "per step", p0, "vision, lr 1e-3, images per step")
    run(cfg, 1e-3, "fixed", p0, "vision, lr 1e-3, one image set")
    run(cfg, 3e-4, "per step", p0, "vision, lr 3e-4, images per step")
    del p0
    dense = dataclasses.replace(cfg, family="dense", n_layers=4, cross_every=0)
    p0 = cs.build(dense, "cuda").init(torch.Generator(device="cuda").manual_seed(0))
    run(dense, 1e-3, None, p0, "dense, its width, 4 layers, lr 1e-3")
    run(dense, 3e-4, None, p0, "dense, its width, 4 layers, lr 3e-4")


if __name__ == "__main__":
    main()
