"""Plain PyTorch attention (the flash kernels' oracles).

Layout convention, as in the JAX package: q (B, Sq, H, D); k, v
(B, Skv, KVH, D) with H = G * KVH (query head h reads KV head h // G).
Masks: causal, sliding window (attend to the last ``window`` positions
including self), or none. All math in f32; the output takes q's dtype.
A row with no visible key gets the uniform softmax over NEG_INF scores,
i.e. the mean of v, exactly like the reference's ``attention_ref``.

``attention_fwd_ref`` also returns the log-sum-exp of each row's scaled
scores, (B, H, Sq) f32, as the reference's ``chunked._fwd_impl`` saves
it for the backward. ``attention_bwd_ref`` is the flash-2 backward of
``chunked._bwd_rule`` on this layout, and the exact gradient of
``attention_ref``: a row with no visible key (whose lse is NEG_INF, so
that p cannot be recomputed from it) weighs every key by 1 / Skv in dV
and passes no gradient to its scores.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "attention_fwd_ref", "attention_bwd_ref", "decode_attention_ref",
           "NEG_INF"]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _mask(sq, skv, causal, window, q_offset, device):
    """(Sq, Skv) visibility of each key to each query."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    return mask


def _scores(q, k, causal, window, scale, q_offset):
    """Masked scaled scores (B, KVH, G, Sq, Skv) in f32, the mask, and the
    scale."""
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, kvh, h // kvh, d) * scale
    s = torch.einsum("bqkgd,bjkd->bkgqj", qf, k.float())
    mask = _mask(sq, skv, causal, window, q_offset, q.device)
    return torch.where(mask, s, NEG_INF), mask, scale


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
    mask = _mask(sq, skv, causal, window, q_offset, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return o.to(q.dtype)


def attention_fwd_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                      scale: float | None = None, q_offset: int = 0):
    """``(o, lse)``: ``attention_ref``'s output and each row's
    ``m + log(l)`` over its scaled scores, (B, H, Sq) f32, with the
    reference's ``l == 0`` guard."""
    b, sq, h, d = q.shape
    s, _, _ = _scores(q, k, causal, window, scale, q_offset)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bkgqj,bjkd->bqkgd", e / l_safe, v.float()).reshape(b, sq, h, d)
    lse = (m + torch.log(l_safe))[..., 0].reshape(b, h, sq)
    return o.to(q.dtype), lse


def attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True, window: int | None = None,
                      scale: float | None = None, q_offset: int = 0):
    """``(dq, dk, dv)`` of attention from the forward's ``o`` and ``lse``,
    in f32 and cast to the operands' dtypes:

        D = rowsum(dO o);  p = exp(s - lse);  dV = p^T dO
        dS = p (dO V^T - D) scale;  dQ = dS K;  dK = dS^T Q

    dK and dV sum over the G query heads of each KV head. Masked scores
    get no gradient; a row with no visible key has p = 1 / Skv."""
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    g = h // kvh
    s, mask, scale = _scores(q, k, causal, window, scale, q_offset)
    grouped = (b, sq, kvh, g, d)
    dof = do.float().reshape(grouped)
    dD = (dof * o.float().reshape(grouped)).sum(-1).permute(0, 2, 3, 1)  # (B, KVH, G, Sq)
    p = torch.exp(s - lse.reshape(b, kvh, g, sq)[..., None])
    live = mask.any(dim=-1)[:, None]  # (Sq, 1): the row sees a key
    p = torch.where(live, p, 1.0 / skv)
    dv = torch.einsum("bkgqj,bqkgd->bjkd", p, dof)
    dp = torch.einsum("bqkgd,bjkd->bkgqj", dof, v.float())
    ds = torch.where(mask, p * (dp - dD[..., None]) * scale, 0.0)
    dq = torch.einsum("bkgqj,bjkd->bqkgd", ds, k.float()).reshape(b, sq, h, d)
    dk = torch.einsum("bkgqj,bqkgd->bjkd", ds, q.float().reshape(grouped))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q, k_cache, v_cache, *, length, window: int | None = None,
                         scale: float | None = None, return_lse: bool = False):
    """The plain decode step (``decode_attention``'s CPU path): q (B, 1,
    H, D) attends to the first ``length`` cache slots (and at most the
    trailing ``window`` of them, the newest slot ``length - 1``
    included). ``length`` is an int or a per-batch tensor. A row with no
    valid slot returns exact zeros. The reference's arithmetic: q scaled
    in f32 and rounded to its dtype, scores and output summed in f32, the
    normalised p rounded to the cache's dtype before P V.

    ``return_lse`` returns ``(o, lse)`` instead: o in f32 (not yet cast
    to q's dtype) and each row's log-sum-exp of its scaled scores, (B, 1,
    H) f32, -inf for a row with no valid slot, so that the partial results
    of a sequence-sharded cache can be merged (``models/layers.py``)."""
    b, _, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    qf = (q.float() * scale).to(q.dtype).reshape(b, kvh, g, d)
    kc = k_cache.transpose(1, 2)  # (B, KVH, S, D)
    vc = v_cache.transpose(1, 2)
    logits = torch.einsum("bkgd,bksd->bkgs", qf.float(), kc.float())

    pos = torch.arange(s, device=q.device)[None, :]
    # an int length stays a Python scalar: no host-to-device copy per call
    lengths = length if isinstance(length, int) else (
        torch.as_tensor(length, device=q.device).reshape(-1, 1))
    valid = pos < lengths
    if window is not None:
        valid = valid & (pos >= lengths - window)
    vmask = valid.expand(b, s)[:, None, None, :]
    logits = torch.where(vmask, logits, torch.finfo(torch.float32).min * 0.7)
    m = logits.amax(dim=-1, keepdim=True)
    # Masked slots are zeroed explicitly, so a row with no valid slot
    # (length 0, or a window that excludes everything) is exact zeros.
    p = torch.where(vmask, torch.exp(logits - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom > 0.0, denom, 1.0)
    o = torch.einsum("bkgs,bksd->bkgd", p.to(v_cache.dtype).float(), vc.float())
    if return_lse:
        lse = torch.where(denom > 0.0, m + torch.log(denom), -math.inf)
        return o.reshape(b, 1, h, d), lse.reshape(b, 1, h)
    return o.reshape(b, 1, h, d).to(q.dtype)
