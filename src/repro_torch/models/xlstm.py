"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

mLSTM runs as two SSD scans, as in the JAX package:

  C_t = f_t C_{t-1} + (i_t k_t) v_t^T       -> ssm_scan(u=v, ld=log f, B=i*k, C=q)
  n_t = f_t n_{t-1} + (i_t k_t)             -> ssm_scan(u=1, ...) with P=1
  y_t = (C_t^T q_t) / max(|n_t^T q_t|, 1)

Prefill and train run the chunked scan (``ssm_scan``: the CUDA kernel on
the card, its autograd Function in training, B and C per head); decode
advances both by one ``ssm_step_ref``, as the reference does. sLSTM is
sequential over time: every mode runs ``slstm_scan``, the hand-written
recurrence kernel on the card and its plain loop on the CPU. Casts
follow the reference's order: k divided by sqrt(N) in the compute dtype,
the gates and the scans' decays in f32, i*k cast back to the compute
dtype, the normaliser's ``ones`` in the compute dtype, the sLSTM's
inputs and r in f32.

The reference's ``max(|yn|, 1)`` and ``min(i, 10)`` split their
gradient in halves at a tie (``jnp.maximum``, ``jnp.minimum``); so do
``torch.maximum`` and ``torch.minimum`` here.

On a mesh (a ``layers.Layout`` with ``heads``: the 4 heads divide
``model``) both blocks run on this rank's heads: every in-projection
gives the rank's columns (column-parallel under ``megatron``, K-split
partials reduce-scattered onto them under ``dos``), the mLSTM's ``bf``,
the sLSTM's ``bf`` and ``r`` are cut to the local heads, the norms over
all heads (the mLSTM's over ``heads_flat``, the sLSTM's over E)
all-reduce their sums of squares, and ``wo`` is row-parallel (or
K-split) into the residual. Where the heads do not divide ``model`` the
blocks run whole on every rank. The states are the local heads' (the
decoder moves them to and from the cache's placement).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import slstm_scan, ssm_scan, ssm_step_ref
from ..parallel import collectives as C
from .layers import ONE, Layout, proj, rmsnorm
from .params import ParamDef

__all__ = [
    "mlstm_defs", "mlstm_block", "mlstm_init_state",
    "slstm_defs", "slstm_block", "slstm_init_state",
]


# --- mLSTM -------------------------------------------------------------------


def mlstm_defs(cfg):
    e = cfg.d_model
    h = cfg.n_heads
    n = cfg.ssm_state  # key/query dim per head
    p_ = cfg.ssm_head_dim  # value dim per head
    return {
        "wq": ParamDef((e, h * n), ("embed", "heads_flat"), contract=0, out=1),
        "wk": ParamDef((e, h * n), ("embed", "heads_flat"), contract=0, out=1),
        "wv": ParamDef((e, h * p_), ("embed", "heads_flat"), contract=0, out=1),
        "wi": ParamDef((e, h), ("embed", "ssm_heads"), contract=0, out=1),
        "wf": ParamDef((e, h), ("embed", "ssm_heads"), contract=0, out=1),
        "bf": ParamDef((h,), ("ssm_heads",), init="ones"),
        "wo_gate": ParamDef((e, h * p_), ("embed", "heads_flat"), contract=0, out=1),
        "norm": ParamDef((h * p_,), ("heads_flat",), init="ones"),
        "wo": ParamDef((h * p_, e), ("heads_flat", "embed"), contract=0, out=1),
    }


def mlstm_init_state(cfg, batch, device=None):
    h, n, p_ = cfg.n_heads, cfg.ssm_state, cfg.ssm_head_dim
    return {
        "C": torch.zeros((batch, h, n, p_), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, n, 1), dtype=torch.float32, device=device),
    }


def _f32_scalar(value, like):
    """A 0-d f32 tensor on ``like``'s device, filled there (no host copy)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _inproj(p, x, name, lay: Layout, group: str):
    """An in-projection's columns of this rank's heads (all of them where
    the heads do not split)."""
    return proj(x, p[name], None, lay, lay.dim(group, name), lay.resid, lay.heads)


def _heads_of(t, lay: Layout, dim: int = 0):
    """A replicated per-head leaf cut to this rank's heads."""
    return C.split(t, lay.mesh, lay.tp, dim) if lay.heads else t


def mlstm_block(p, x, cfg, *, mode: str, state=None, lay: Layout = ONE):
    """Returns (y, new_state). ``state`` is required for decode; prefill
    and train start from zeros (train's final state is returned and
    dropped by the decoder, as in the reference). On a mesh (``lay``) x
    and y are split on E if ``lay.resid``, and the state holds this
    rank's heads if ``lay.heads``."""
    b, s, e = x.shape
    h, n, p_ = cfg.n_heads, cfg.ssm_state, cfg.ssm_head_dim
    if lay.heads:
        h //= lay.m

    def inproj(name):
        return _inproj(p, x, name, lay, "kind_mlstm")

    q = inproj("wq").reshape(b, s, h, n)
    k = inproj("wk").reshape(b, s, h, n) / (n**0.5)
    v = inproj("wv").reshape(b, s, h, p_)
    i_pre = inproj("wi").float()  # (B, S, H)
    f_pre = inproj("wf").float() + _heads_of(p["bf"], lay).float()

    # stabilized exponential gating: the input gate folded into B, log f
    # the decay
    ld = F.logsigmoid(f_pre)  # (B, S, H)
    i_gate = torch.exp(torch.minimum(i_pre, _f32_scalar(10.0, x)))
    Bk = (k.float() * i_gate[..., None]).to(x.dtype)  # i_t * k_t

    ones = torch.ones((b, s, h, 1), dtype=x.dtype, device=x.device)
    if mode == "decode":
        if state is None or s != 1:
            raise ValueError("decode takes one token and a state")
        yc, new_c = ssm_step_ref(state["C"], v[:, 0], ld[:, 0], Bk[:, 0], q[:, 0])
        yn, new_n = ssm_step_ref(state["n"], ones[:, 0], ld[:, 0], Bk[:, 0], q[:, 0])
        yc, yn = yc[:, None], yn[:, None]
    elif mode in ("prefill", "train"):
        yc, new_c = ssm_scan(v, ld, Bk, q)  # (B, S, H, P)
        yn, new_n = ssm_scan(ones, ld, Bk, q)  # (B, S, H, 1)
    else:
        raise ValueError(f"mlstm_block: unknown mode {mode!r}")

    denom = torch.maximum(yn.float().abs(), _f32_scalar(1.0, x))
    y = (yc.float() / denom).reshape(b, s, h * p_)
    y = rmsnorm(y.to(x.dtype), p["norm"], cfg.norm_eps, lay, lay.heads)
    o_gate = torch.sigmoid(inproj("wo_gate").float())
    y = (y.float() * o_gate).to(x.dtype)
    out = proj(y, p["wo"], None, lay, lay.dim("kind_mlstm", "wo"), lay.heads, lay.resid)
    return out, {"C": new_c, "n": new_n}


# --- sLSTM --------------------------------------------------------------------


def slstm_defs(cfg):
    e = cfg.d_model
    h = cfg.n_heads
    d_h = e // h
    # recurrent weights are per-head block-diagonal (xLSTM's heads)
    return {
        "wz": ParamDef((e, e), ("embed", "heads_flat"), contract=0, out=1),
        "wi": ParamDef((e, h), ("embed", "ssm_heads"), contract=0, out=1),
        "wf": ParamDef((e, h), ("embed", "ssm_heads"), contract=0, out=1),
        "wo_gate": ParamDef((e, e), ("embed", "heads_flat"), contract=0, out=1),
        "bf": ParamDef((h,), ("ssm_heads",), init="ones"),
        "r": ParamDef((h, d_h, d_h), ("heads", "head_dim", "head_dim"), scale=0.1),
        "norm": ParamDef((e,), ("embed",), init="ones"),
        "wo": ParamDef((e, e), ("heads_flat", "embed"), contract=0, out=1),
    }


def slstm_init_state(cfg, batch, device=None):
    e, h = cfg.d_model, cfg.n_heads
    return {
        "c": torch.zeros((batch, e), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h), dtype=torch.float32, device=device),
        "h": torch.zeros((batch, e), dtype=torch.float32, device=device),
    }


def slstm_block(p, x, cfg, *, mode: str, state=None, lay: Layout = ONE):
    """Scalar-memory LSTM with a recurrent (previous-output) term, walked
    over time by ``slstm_scan``. Returns (y, new_state); ``state`` (the
    cache in decode) or zeros is the initial state. On a mesh (``lay``)
    x and y are split on E if ``lay.resid``; the recurrence runs at this
    rank's heads (E / m wide) if ``lay.heads``, and so does the state."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"slstm_block: unknown mode {mode!r}")
    b = x.shape[0]

    def inproj(name):
        return _inproj(p, x, name, lay, "kind_slstm").float()

    z_in, i_in, o_in = inproj("wz"), inproj("wi"), inproj("wo_gate")
    f_in = inproj("wf") + _heads_of(p["bf"], lay).float()
    if state is None:
        if mode == "decode":
            raise ValueError("decode takes one token and a state")
        state = {k: _heads_of(t, lay, 1) for k, t in slstm_init_state(cfg, b, x.device).items()}
    ys, c, n, h_last = slstm_scan(z_in, i_in, f_in, o_in, _heads_of(p["r"], lay).float(),
                                  state["c"], state["n"], state["h"])
    y = rmsnorm(ys.to(x.dtype), p["norm"], cfg.norm_eps, lay, lay.heads)
    out = proj(y, p["wo"], None, lay, lay.dim("kind_slstm", "wo"), lay.heads, lay.resid)
    return out, {"c": c, "n": n, "h": h_last}
