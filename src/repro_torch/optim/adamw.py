"""AdamW with global-norm clipping, on the parameter tree (dicts and lists).

Plain functions with the JAX package's formulas, in the order of its
operations, so that one step from the same numpy params, grads and state
agrees with the reference to f32 rounding:

- clip: ``g * min(1, clip_norm / (gnorm + 1e-9))`` with ``gnorm`` the
  global norm over every leaf in f32;
- moments ``m = b1 m + (1 - b1) g`` and ``v = b2 v + (1 - b2) g g``;
- bias correction ``1 - b ** step``;
- ``u = m_hat / (sqrt(v_hat) + eps) + wd p`` and ``p - lr u``.

The state is the reference's tree ``{"m", "v", "step"}`` (``step`` a 0-d
int32 tensor), so checkpoints cross between the two packages.
``torch.optim.AdamW`` is not used: its clip and the order of its decay
round differently, and its state is not that tree. The update is in
place, as the reference's jitted step donates its params and moments: it
writes the new parameters and moments into the given f32 tensors, leaf by
leaf, so that a step never holds two copies of them. A caller that needs
the old values clones them first. Nothing here synchronises with the
device.

Each leaf's update and each leaf's sum of squares is one call of
``kernels.adamw`` (``adamw``, ``sum_squares``): on the card a hand-written
kernel each (two launches a leaf), on the CPU their plain versions.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.adamw import adamw, sum_squares
from ..models.params import leaves, map_tree
from ..parallel import collectives as C
from ..parallel.axes import spec_axes

__all__ = ["OptConfig", "schedule", "init_opt_state", "global_norm", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: OptConfig, step):
    """Linear warmup + cosine decay: the learning rate at ``step`` (an int
    or a tensor) as an f32 tensor."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params):
    device = next(_leaves(params)).device
    return {
        "m": map_tree(torch.zeros_like, params),
        "v": map_tree(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _leaves(tree):
    """Leaves in the reference's order (sorted keys, list indices)."""
    return (leaf for _, leaf in leaves(tree))


def global_norm(tree, shards=None):
    """sqrt of the sum of every leaf's sum of squares, in f32, summed
    leaf by leaf in the reference's order. ``shards`` (a mesh and every
    leaf's spec, by path) says that the leaves are this rank's shards:
    the leaves split over the same mesh axes are summed, and each such
    sum all-reduced over those axes (a leaf counts once, however many
    ranks hold it)."""
    pairs = list(leaves(tree))
    sums = sum_squares([x for _, x in pairs])
    if shards is None:
        total = 0
        for s in sums:
            total = total + s
        return torch.sqrt(total)
    mesh, spec_of = shards
    by_axes: dict = {}
    for (path, _), s in zip(pairs, sums):
        axes = tuple(a for part in spec_of[path] for a in spec_axes(part))
        by_axes[axes] = by_axes.get(axes, 0) + s
    return torch.sqrt(sum(C.psum(t, mesh, axes) for axes, t in by_axes.items()))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig, *, shards=None):
    """One AdamW step: ``(params, new state, gnorm)``, where ``params`` and
    the new state's moments are the given f32 tensors, updated in place.
    With ``shards`` (``global_norm``'s) they are this rank's shards, and
    the clip reads the global norm of the whole tree."""
    step = state["step"] + 1
    lr = schedule(cfg, step)

    gnorm = global_norm(grads, shards)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for p, g, m_, v_ in zip(*(list(_leaves(t)) for t in (params, grads, state["m"],
                                                           state["v"]))):
        if not p.dtype == m_.dtype == v_.dtype == torch.float32:
            raise TypeError(f"AdamW updates f32 parameters and moments in place; got "
                            f"{p.dtype}, {m_.dtype}, {v_.dtype}")
        adamw(p, g, m_, v_, scale, lr, bc1, bc2, b1=b1, b2=b2, eps=cfg.eps,
              weight_decay=cfg.weight_decay)
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm
