"""Plain PyTorch oracles of the SSD scan, step by step.

Generalized linear-recurrence (SSD) form, per batch b and head h:

    s_t = a_t * s_{t-1} + B_t u_t^T          s in R^{N x P}
    y_t = s_t^T C_t                          y in R^P

where a_t = exp(ld_t) is a scalar-per-(step, head) decay given as the
log-decay ld_t <= 0, and u_t in R^P is the (already scaled) input. For
Mamba2, ld_t = dt_t * A_h and u_t = dt_t * x_t. All math in f32; y
takes u's dtype and the state stays f32, as in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["ssm_scan_ref", "ssm_step_ref"]


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
