"""The plain PyTorch AdamW leaf update and sum of squares: the CPU path of
``ops.py``, and what ``chip_smoke.py`` holds the kernels to on the card.

``adamw_ref`` is the port's update as the optimizer ran it before the
kernel (``optim/adamw.py``), in the reference's order of operations
(``src/repro/optim/adamw.py:72-84``), in place on the f32 leaf and its
moments.
"""

from __future__ import annotations

import torch

__all__ = ["adamw_ref", "sum_squares_ref"]


def adamw_ref(p, g, m, v, scale, lr, bc1, bc2, *, b1, b2, eps, weight_decay):
    """One leaf's AdamW step, in place on ``p``, ``m`` and ``v`` (f32):
    the clip ``scale``, both moments, the bias corrections ``bc1`` and
    ``bc2``, the decay and the update at ``lr``. ``scale``, ``lr``,
    ``bc1`` and ``bc2`` are f32 scalars; ``b1``, ``b2``, ``eps`` and
    ``weight_decay`` Python floats."""
    g = g.float() * scale
    m.mul_(b1).add_(g * (1 - b1))
    v.mul_(b2).add_((g * (1 - b2)).mul_(g))
    del g  # before the update's temporaries: one leaf's at a time
    u = m / bc1
    u.div_((v / bc2).sqrt_().add_(eps))
    u.add_(weight_decay * p)
    p.sub_(u.mul_(lr))


def sum_squares_ref(xs):
    """Each tensor's sum of squares in f32, as one (len(xs),) f32 vector."""
    return torch.stack([torch.sum(torch.square(x.float())) for x in xs])
