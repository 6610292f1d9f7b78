"""Plain PyTorch versions of the sLSTM recurrence and its backward.

The recurrence of xLSTM's scalar-memory block, per batch b, head h
(width d = E / H) and step t, all in f32 (the reference casts its
inputs to f32 before its ``lax.scan``):

    rec   = h_{t-1} r[h]                      (per-head block diagonal)
    z     = tanh(z_in_t + rec)
    i     = exp(min(i_in_t, 10)),  f = sigmoid(f_in_t)    (per head)
    c     = f c + i z,             n = f n + i
    h_t   = sigmoid(o_in_t) * (c / max(n, 1))

``slstm_scan_ref`` is a Python loop over time that mirrors the
reference's ``step`` (xlstm.py); its autograd is the reference's
gradient, ties included: ``torch.minimum`` and ``torch.maximum`` split
the gradient in halves at a tie, as ``jnp.minimum`` and ``jnp.maximum``
do. ``slstm_scan_bwd_ref`` is the closed-form gradient the backward
kernel computes, a loop over time in reverse; the JAX package has no
such function: it differentiates its scan by autodiff.
"""

from __future__ import annotations

import torch

__all__ = ["slstm_dr", "slstm_scan_bwd_ref", "slstm_scan_ref"]


def _per_head(t, d):
    """(B, E) -> (B, H, d)."""
    return t.reshape(t.shape[0], -1, d)


def slstm_scan_ref(z_in, i_in, f_in, o_in, r, c0, n0, h0, store: bool = False):
    """z_in, o_in (B, S, E), i_in, f_in (B, S, H), r (H, d, d), the state
    c0, h0 (B, E) and n0 (B, H), all f32. Returns ``(ys (B, S, E), c, n,
    h)``: every step's h and the final state; with ``store`` also each
    step's ``(c, n, z)``, (B, S, E), (B, S, H), (B, S, E): what the
    closed-form backward reads."""
    b, s, e = z_in.shape
    hd = r.shape[0]
    d = e // hd
    ten, one = i_in.new_full((), 10.0), n0.new_full((), 1.0)  # fills: no host copy
    c, n, hp = c0, n0, h0
    ys, cs, ns, zs = [], [], [], []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", _per_head(hp, d), r).reshape(b, e)
        z = torch.tanh(z_in[:, t] + rec)
        ig = torch.exp(torch.minimum(i_in[:, t], ten))
        fg = torch.sigmoid(f_in[:, t])
        c = fg.repeat_interleave(d, -1) * c + ig.repeat_interleave(d, -1) * z
        n = fg * n + ig
        hh = _per_head(c, d) / torch.maximum(n, one)[..., None]
        hp = torch.sigmoid(o_in[:, t]) * hh.reshape(b, e)
        ys.append(hp)
        if store:
            cs.append(c)
            ns.append(n)
            zs.append(z)
    if not s:  # nothing to walk: no outputs, the state as it was
        out = (z_in.new_zeros(z_in.shape), c, n, hp)
        return (out, (z_in.new_zeros(z_in.shape), i_in.new_zeros(i_in.shape),
                      z_in.new_zeros(z_in.shape))) if store else out
    out = (torch.stack(ys, 1), c, n, hp)
    if store:
        return out, (torch.stack(cs, 1), torch.stack(ns, 1), torch.stack(zs, 1))
    return out


def slstm_dr(h0, ys, dz_in, heads: int):
    """The gradient of r, (H, d, d): d rec_t = dz_in_t, so dr[h] = sum
    over b and t of h_{t-1}[b, h]^T dz_in_t[b, h], with h_{-1} = h0; one
    product per head over K = B * S."""
    b, s, e = ys.shape
    d = e // heads
    h_prev = torch.cat([h0[:, None], ys[:, :-1]], dim=1)  # (B, S, E)
    hp = h_prev.reshape(b * s, heads, d).transpose(0, 1)  # (H, B*S, d)
    dz = dz_in.reshape(b * s, heads, d).transpose(0, 1)
    return torch.matmul(hp.transpose(1, 2), dz)


def slstm_scan_bwd_ref(i_in, f_in, o_in, r, c0, n0, saved, dys, dc=None, dn=None, dh=None):
    """The closed-form gradient of ``slstm_scan_ref`` (the backward
    kernel's math, step by step in reverse). ``saved`` is the forward's
    ``(c_all, n_all, z_all)``; ``dys`` (B, S, E) the gradient of ys and
    ``dc``, ``dn``, ``dh`` that of the final state (None: zero). Returns
    ``(dz_in, di_in, df_in, do_in, dc0, dn0, dh0)``; dr is ``slstm_dr``.
    Per step t, from the carried dh (into h_t), dc (into c_t), dn (into
    n_t), with m = max(n_t, 1), q = c_t / m, o = sigmoid(o_in_t):

        dh += dy_t;  do_in = dh q o (1 - o);  dq = dh o;  dc += dq / m
        dn += [n_t > 1] (-sum dq q / m)      (half of it at n_t == 1)
        df = sum dc c_{t-1} + dn n_{t-1};  di = sum dc z + dn
        di_in = di i [i_in < 10] (half at 10);  df_in = df f (1 - f)
        dz_in = dc i (1 - z^2);  carried: dc f, dn f, dh = dz_in r[h]^T
    """
    c_all, n_all, z_all = saved
    b, s, e = dys.shape
    hd = r.shape[0]
    d = e // hd
    rep = (lambda x: x.repeat_interleave(d, -1))
    dc = torch.zeros_like(c0) if dc is None else dc
    dn = torch.zeros_like(n0) if dn is None else dn
    dh = torch.zeros_like(c0) if dh is None else dh
    dz_in, do_in = torch.empty_like(dys), torch.empty_like(dys)
    di_in, df_in = torch.empty_like(i_in), torch.empty_like(f_in)
    for t in reversed(range(s)):
        c, n, z = c_all[:, t], n_all[:, t], z_all[:, t]
        c_prev = c_all[:, t - 1] if t else c0
        n_prev = n_all[:, t - 1] if t else n0
        it, ft = i_in[:, t], f_in[:, t]
        ig = torch.exp(torch.clamp(it, max=10.0))
        fg = torch.sigmoid(ft)
        og = torch.sigmoid(o_in[:, t])
        m = torch.clamp(n, min=1.0)
        q = c / rep(m)
        dht = dys[:, t] + dh
        do_in[:, t] = dht * q * og * (1 - og)
        dq = dht * og
        dct = dc + dq / rep(m)
        dm = -_per_head(dq * q, d).sum(-1) / m
        dnt = dn + torch.where(n > 1, dm, torch.where(n == 1, 0.5 * dm, torch.zeros_like(dm)))
        dfg = _per_head(dct * c_prev, d).sum(-1) + dnt * n_prev
        dig = _per_head(dct * z, d).sum(-1) + dnt
        gate = torch.where(it < 10, 1.0, torch.where(it == 10, 0.5, 0.0))
        di_in[:, t] = dig * ig * gate
        df_in[:, t] = dfg * fg * (1 - fg)
        dpre = dct * rep(ig) * (1 - z * z)
        dz_in[:, t] = dpre
        dc, dn = dct * rep(fg), dnt * fg
        dh = torch.einsum("bhe,hde->bhd", _per_head(dpre, d), r).reshape(b, e)
    return dz_in, di_in, df_in, do_in, dc, dn, dh
