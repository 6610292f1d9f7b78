"""Plain PyTorch oracles of the SSD scan, step by step.

Generalized linear-recurrence (SSD) form, per batch b and head h:

    s_t = a_t * s_{t-1} + B_t u_t^T          s in R^{N x P}
    y_t = s_t^T C_t                          y in R^P

where a_t = exp(ld_t) is a scalar-per-(step, head) decay given as the
log-decay ld_t <= 0, and u_t in R^P is the (already scaled) input. For
Mamba2, ld_t = dt_t * A_h and u_t = dt_t * x_t. All math in f32; y
takes u's dtype and the state stays f32, as in the JAX package.

``ssm_scan_bwd_ref`` is the closed-form gradient of the chunked scan
(``ops.ssm_scan_chunked``), chunked as the forward is; the JAX package
has no such function: it differentiates its jnp twin by autodiff.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["ssm_scan_bwd_ref", "ssm_scan_ref", "ssm_step_ref"]


def ssm_step_ref(state, u_t, ld_t, B_t, C_t):
    """One decode step. state: (Bt, H, N, P) f32; u_t: (Bt, H, P);
    ld_t: (Bt, H); B_t, C_t: (Bt, H, N). Returns (y_t, new_state)."""
    a_t = torch.exp(ld_t.float())
    state = (a_t[:, :, None, None] * state
             + B_t.float()[:, :, :, None] * u_t.float()[:, :, None, :])
    y_t = torch.einsum("bhnp,bhn->bhp", state, C_t.float())
    return y_t.to(u_t.dtype), state


def ssm_scan_ref(u, ld, B, C, s0=None):
    """u: (Bt, S, H, P), ld: (Bt, S, H), B, C: (Bt, S, H, N).
    Returns y (Bt, S, H, P) in u's dtype and the final state
    (Bt, H, N, P) in f32, one step at a time."""
    bt, s, h, p = u.shape
    n = B.shape[-1]
    state = (torch.zeros((bt, h, n, p), dtype=torch.float32, device=u.device)
             if s0 is None else s0)
    ys = []
    for t in range(s):
        y_t, state = ssm_step_ref(state, u[:, t].float(), ld[:, t], B[:, t], C[:, t])
        ys.append(y_t)
    y = torch.stack(ys, dim=1) if ys else torch.zeros(u.shape, device=u.device)
    return y.to(u.dtype), state


class _Chunks(NamedTuple):
    """The chunked scan's f32 operands, laid out (Bt, n_chunks, T, H, ...)."""

    T: int
    u: torch.Tensor  # (bt, nc, T, h, p)
    B: torch.Tensor  # (bt, nc, T, h, n)
    C: torch.Tensor
    la: torch.Tensor  # (bt, nc, T, h) cumsum(ld) inside each chunk
    lmat: torch.Tensor  # (bt, nc, i, j, h) exp(la_i - la_j), 0 above the diagonal
    dec: torch.Tensor  # (bt, nc, T, h) exp(la_T - la_j)
    states: torch.Tensor  # (bt, nc, h, n, p) the state entering each chunk
    final: torch.Tensor  # (bt, h, n, p) the state after the last


def _pad_chunks(t, T):
    """(Bt, S, H, ...) f32, padded with zeros to whole chunks and split
    into them: (Bt, n_chunks, T, H, ...)."""
    t = t.float()
    pad = -t.shape[1] % T
    if pad:
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], -1, T, *t.shape[2:])


def _chunks(u, ld, B, C, chunk: int) -> _Chunks:
    """What the chunked scan and its backward share: the operands in
    chunks of T = min(chunk, S) steps, a ragged S padded with identity
    steps (ld = 0 decays by 1, u = B = 0 add nothing), the decays, and the
    states, carried by a loop over the chunks. The exponent of L is masked
    BEFORE the exp: the j > i entries are positive log-decays whose exp
    overflows (and inf * 0 would leak NaN into a gradient)."""
    bt, s, h, p = u.shape
    n = B.shape[-1]
    T = min(chunk, s)
    uf, Bf, Cf = (_pad_chunks(t, T) for t in (u, B, C))
    la = torch.cumsum(_pad_chunks(ld, T), dim=2)
    li = la[:, :, :, None, :] - la[:, :, None, :, :]
    tri = torch.ones((T, T), dtype=torch.bool, device=u.device).tril()
    lmat = torch.exp(torch.where(tri[None, None, :, :, None], li, -1e30))
    decay_tot = torch.exp(la[:, :, -1, :])  # (bt, nc, h)
    dec = torch.exp(la[:, :, -1:, :] - la)
    s_inc = torch.einsum("bcjhn,bcjhp->bchnp", Bf * dec[..., None], uf)
    state = torch.zeros((bt, h, n, p), dtype=torch.float32, device=u.device)
    entering = []
    for c in range(uf.shape[1]):
        entering.append(state)
        state = decay_tot[:, c, :, None, None] * state + s_inc[:, c]
    return _Chunks(T, uf, Bf, Cf, la, lmat, dec, torch.stack(entering, dim=1), state)


def ssm_scan_bwd_ref(u, ld, B, C, dy, d_state=None, chunk: int = 32):
    """The gradient of the chunked scan ``(y, state) = ssm_scan_chunked(u,
    ld, B, C, chunk)`` given ``dy`` (Bt, S, H, P) and ``d_state`` (Bt, H,
    N, P), or None where the caller dropped the state. Returns (du, dld,
    dB, dC), all f32, dB and dC per head (Bt, S, H, N) whatever B's head
    stride. In f32, per (b, h) and chunk c of T steps, la = cumsum(ld)
    inside the chunk, L_ij = exp(la_i - la_j) for j <= i (masked before
    the exp), S_c the state entering the chunk and dS_{c+1} the gradient
    of the state leaving it (d_state, or 0, after the last chunk):

        dS_c  = exp(la_T) dS_{c+1} + sum_i exp(la_i) C_i dy_i^T
        du_j  = sum_i (C_i.B_j) L_ij dy_i + exp(la_T - la_j) dS_{c+1}^T B_j
        dB_j  = sum_i L_ij (dy_i.u_j) C_i + exp(la_T - la_j) dS_{c+1} u_j
        dC_i  = sum_j L_ij (dy_i.u_j) B_j + exp(la_i) S_c dy_i

    and d(la) collects the terms of each exponent: +a_ij at i and -a_ij at
    j for a_ij = (C_i.B_j)(dy_i.u_j) L_ij; exp(la_i) dy_i.(S_c^T C_i) at
    i; f_j = exp(la_T - la_j) B_j.(dS_{c+1} u_j) at la_T and -f_j at j;
    exp(la_T) <dS_{c+1}, S_c> at la_T. dld is the reverse cumsum of d(la)
    inside the chunk. A ragged S is padded with identity steps, as in the
    forward."""
    bt, s, h, p = u.shape
    n = B.shape[-1]
    dev = u.device
    if s == 0:
        z = torch.zeros((bt, 0, h, n), dtype=torch.float32, device=dev)
        return (torch.zeros(u.shape, dtype=torch.float32, device=dev),
                torch.zeros(ld.shape, dtype=torch.float32, device=dev), z, z.clone())
    k = _chunks(u, ld, B, C, chunk)
    uf, Bf, Cf, la, lmat, eout, states = k.u, k.B, k.C, k.la, k.lmat, k.dec, k.states
    dyf = _pad_chunks(dy, k.T)
    nc = uf.shape[1]
    la_T = la[:, :, -1, :]  # (bt, nc, h)
    ein = torch.exp(la)  # exp(la_i)

    # the gradient of the state leaving each chunk, in reverse
    ds_inc = torch.einsum("bcihn,bcihp->bchnp", Cf * ein[..., None], dyf)
    dnext = [None] * nc
    ds = (torch.zeros((bt, h, n, p), dtype=torch.float32, device=dev) if d_state is None
          else d_state.float())
    for c in reversed(range(nc)):
        dnext[c] = ds
        ds = torch.exp(la_T[:, c, :, None, None]) * ds + ds_inc[:, c]
    dnext = torch.stack(dnext, dim=1)  # (bt, nc, h, n, p)

    cb = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf)
    dyu = torch.einsum("bcihp,bcjhp->bcijh", dyf, uf)
    ldu = lmat * dyu
    du = (torch.einsum("bcijh,bcihp->bcjhp", cb * lmat, dyf)
          + eout[..., None] * torch.einsum("bcjhn,bchnp->bcjhp", Bf, dnext))
    dsu = eout[..., None] * torch.einsum("bchnp,bcjhp->bcjhn", dnext, uf)  # exp(.) dS_{c+1} u_j
    sdy = ein[..., None] * torch.einsum("bchnp,bcihp->bcihn", states, dyf)  # exp(la_i) S_c dy_i
    dB = torch.einsum("bcijh,bcihn->bcjhn", ldu, Cf) + dsu
    dC = torch.einsum("bcijh,bcjhn->bcihn", ldu, Bf) + sdy

    a = cb * ldu
    f = (Bf * dsu).sum(-1)  # (bt, nc, T, h)
    dla = a.sum(3) - a.sum(2) + (Cf * sdy).sum(-1) - f
    dla[:, :, -1] += f.sum(2) + torch.exp(la_T) * (dnext * states).sum((-2, -1))
    dld = torch.flip(torch.cumsum(torch.flip(dla, (2,)), 2), (2,))

    def out(t, *tail):
        return t.reshape(bt, nc * k.T, h, *tail)[:, :s]

    return out(du, p), out(dld), out(dB, n), out(dC, n)
