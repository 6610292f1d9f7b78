"""Mamba2 (SSD) block, the zamba2 backbone.

Structure, as in the JAX package (conv on the x branch only, one B/C
group):

  x -> in-projections: x_in, z (gate), B, C, dt
  x_in -> causal depthwise conv (width 4) -> silu
  y  = SSD-scan(u = dt*x_in, log-decay = dt*A_h, B, C) + D*x_in
  out = W_o (rmsnorm(y) * silu(z))

Train and prefill run the chunked scan (``ssm_scan``: the CUDA kernel
on the card; in training its autograd Function, whose backward is the
``ssm_scan_bwd`` kernel); train starts from zero states and drops the
final one, as the reference does. Decode advances the recurrence one
step with the plain ``ssm_step_ref`` on every device, as the reference
does (it has no kernel for the step either), carrying (ssm state, conv
state). B and C are broadcast over the heads as views (stride 0), never
copied: the scan takes them with a head dim of 1, so that its backward
sums their gradient over the heads in f32.

On a mesh (a ``layers.Layout`` with ``ssm_heads``) the block runs on
this rank's heads and their Di channels: ``wx``, ``wz`` and ``wdt`` give
them (column-parallel under ``megatron``; under ``dos`` K-split f32
partials reduce-scattered onto Di and onto the heads), the conv runs on
the local channels (``conv_w`` cut to them), ``dt_bias``, ``A`` and ``D``
are cut to the local heads, the gated rmsnorm over all of Di all-reduces
its sum of squares, and ``wo`` is row-parallel (or K-split) into the
residual. B and C (N wide) serve every head: under ``megatron`` ``wB``
and ``wC`` are split on N and their columns are all-gathered (the
gradient reduce-scattered back, as every rank's heads used all of N),
under ``dos`` their K-split partials are all-reduced (the gradient summed
over the ranks). Collectives per block: ``dos`` 3 reduce-scatters
(wx, wz, wdt), 2 all-reduces (wB, wC), 1 for the norm and 1
reduce-scatter or all-reduce out of ``wo``; ``megatron`` 2 all-gathers
(B, C), 1 all-reduce for the norm and 1 out of ``wo``. Where the heads do
not divide ``model`` the block runs whole on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ssm_scan, ssm_step_ref
from ..parallel import collectives as C
from .layers import ONE, Layout, proj, rmsnorm
from .params import ParamDef

__all__ = ["mamba_defs", "mamba_block", "mamba_init_state"]

_CONV_W = 4


def mamba_defs(cfg):
    e = cfg.d_model
    di = cfg.ssm_expand * e
    n = cfg.ssm_state
    h = di // cfg.ssm_head_dim
    return {
        "wx": ParamDef((e, di), ("embed", "ssm_inner"), contract=0, out=1),
        "wz": ParamDef((e, di), ("embed", "ssm_inner"), contract=0, out=1),
        "wB": ParamDef((e, n), ("embed", "state"), contract=0, out=1),
        "wC": ParamDef((e, n), ("embed", "state"), contract=0, out=1),
        "wdt": ParamDef((e, h), ("embed", "ssm_heads"), contract=0, out=1),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "A": ParamDef((h,), ("ssm_heads",), init="neg_linspace"),
        "D": ParamDef((h,), ("ssm_heads",), init="ones"),
        "conv_w": ParamDef((_CONV_W, di), ("conv", "ssm_inner"), init="normal", scale=0.5),
        "norm": ParamDef((di,), ("ssm_inner",), init="ones"),
        "wo": ParamDef((di, e), ("ssm_inner", "embed"), contract=0, out=1),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv, width 4. x: (B, S, Di); state: (B, 3, Di)
    carries the last 3 inputs for decode. Returns (y, new_state)."""
    b, s, di = x.shape
    pad = state if state is not None else x.new_zeros((b, _CONV_W - 1, di))
    xp = torch.cat([pad.to(x.dtype), x], dim=1)  # (B, S+3, Di)
    w = w.to(x.dtype)
    y = xp[:, 0:s] * w[0]
    for i in range(1, _CONV_W):
        y = y + xp[:, i : i + s] * w[i]
    return y, xp[:, -(_CONV_W - 1):]


def mamba_init_state(cfg, batch, dtype=torch.float32, device=None):
    di = cfg.ssm_expand * cfg.d_model
    h = di // cfg.ssm_head_dim
    return {
        "ssm": torch.zeros((batch, h, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_W - 1, di), dtype=dtype, device=device),
    }


def mamba_block(p, x, cfg, *, mode: str, state=None, lay: Layout = ONE):
    """Returns (y, new_state). ``state`` is required for decode; prefill
    starts from zeros and returns the state for the decode loop; train
    starts from zeros and returns no state. On a mesh (``lay``) x and y
    are split on E if ``lay.resid``; the state holds this rank's heads
    (``ssm``) and Di channels (``conv``) if ``lay.ssm_heads``."""
    b, s, e = x.shape
    di = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_head_dim
    h = di // hd
    n = cfg.ssm_state
    mesh, tp, heads = lay.mesh, lay.tp, lay.ssm_heads
    if heads:
        di, h = di // lay.m, h // lay.m

    def inproj(name, out_split):
        return proj(x, p[name], None, lay, lay.dim("layers", name), lay.resid, out_split)

    def local(t, dim=-1):  # a replicated per-channel or per-head leaf cut to this rank's
        return C.split(t, mesh, tp, dim) if heads else t

    x_in = inproj("wx", heads)  # (B, S, Di)
    z = inproj("wz", heads)
    Bm, Cm = _whole_n(inproj, "wB", lay), _whole_n(inproj, "wC", lay)  # (B, S, N)
    dt = F.softplus(inproj("wdt", heads).float() + local(p["dt_bias"]).float())  # (B, S, H)

    x_c, new_conv = _causal_conv(x_in, local(p["conv_w"]),
                                 state["conv"] if mode == "decode" else None)
    xh = F.silu(x_c).reshape(b, s, h, hd)

    A = local(p["A"]).float()
    u = (dt[..., None] * xh.float()).to(x.dtype)
    ld = dt * A  # (B, S, H) log-decay, f32
    if mode == "decode":
        if state is None or s != 1:
            raise ValueError("decode takes one token and a state")
        y1, new_ssm = ssm_step_ref(state["ssm"], u[:, 0], ld[:, 0],
                                   Bm[:, 0, None, :].expand(b, h, n),
                                   Cm[:, 0, None, :].expand(b, h, n))
        y = y1[:, None]  # (B, 1, H, hd)
    elif mode in ("prefill", "train"):
        y, new_ssm = ssm_scan(u, ld, Bm[:, :, None, :], Cm[:, :, None, :])
    else:
        raise ValueError(f"mamba_block: unknown mode {mode!r}")

    y = y + local(p["D"]).to(x.dtype)[None, None, :, None] * xh
    y = rmsnorm(y.reshape(b, s, di), p["norm"], cfg.norm_eps, lay, heads) * F.silu(z)
    out = proj(y.to(x.dtype), p["wo"], None, lay, lay.dim("layers", "wo"), heads, lay.resid)
    if mode == "train":
        return out, None
    return out, {"ssm": new_ssm, "conv": new_conv}


def _whole_n(inproj, name, lay: Layout):
    """B or C (B, S, N), all of N on every rank. On local heads every
    rank reads all of N for its own heads, so the gradient is summed over
    the tensor-parallel ranks: a column-parallel weight's columns are
    gathered with a reduce-scatter backward (``gather_params``), a K-split
    or replicated one's result passes ``copy_to``."""
    if not lay.ssm_heads:
        return inproj(name, False)
    if lay.dim("layers", name) == 1:
        return C.gather_params(inproj(name, True), lay.mesh, lay.tp, -1)
    return C.copy_to(inproj(name, False), lay.mesh, lay.tp)
