"""Plain PyTorch attention (the flash kernel's oracle).

Layout convention, as in the JAX package: q (B, Sq, H, D); k, v
(B, Skv, KVH, D) with H = G * KVH (query head h reads KV head h // G).
Masks: causal, sliding window (attend to the last ``window`` positions
including self), or none. All math in f32; the output takes q's dtype.
A row with no visible key gets the uniform softmax over NEG_INF scores,
i.e. the mean of v, exactly like the reference's ``attention_ref``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "NEG_INF"]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None, q_offset: int = 0):
    """Reference attention. ``q_offset`` places the queries at absolute
    positions [q_offset, q_offset + Sq) relative to the keys."""
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    qi = torch.arange(sq, device=q.device)[:, None] + q_offset
    kj = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return o.to(q.dtype)
