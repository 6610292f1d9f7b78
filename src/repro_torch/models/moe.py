"""Mixture-of-Experts FFN (deepseek-moe's fine-grained experts;
llama4-scout), the counterpart of the JAX package's ``models/moe.py``.

Routing in f32: softmax of the router's logits, the top-k experts of
each token (ties to the lower index, as ``lax.top_k``), their
probabilities renormalised. The T*k (token, expert) pairs are sorted by
expert (a stable sort, as ``jnp.argsort``), each token's row gathered
once per pair, and the experts run as three grouped GEMMs over the
sorted rows (``kernels.grouped_matmul``, the reference's
``jax.lax.ragged_dot``) with ``silu(g) * u`` between them; the rows go
back to (token, k) order, are weighted and summed over k. The shared
experts (deepseek's always-on experts) are a plain gated MLP through
``proj``.

The group sizes are counted on the device (a search of the sorted
expert ids), so a decode step never waits for the host. The gather of
each token k times and the unsort are small autograd Functions whose
backwards are gathers through the inverse permutation and a sum over k:
the backward of indexing would scatter-add floats, which the card does
in no fixed order, and a resumed MoE run must repeat an uninterrupted
one bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import grouped_matmul
from .layers import proj
from .params import ParamDef

__all__ = ["add_shared", "aux_load_balance_loss", "moe_block", "moe_defs", "route",
           "routed_experts"]


def moe_defs(cfg):
    e, f, ne = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    defs = {
        "router": ParamDef((e, ne), ("embed", "experts"), contract=0, out=1),
        "wi_gate": ParamDef((ne, e, f), ("experts", "embed", "expert_ff"), contract=1, out=2),
        "wi_up": ParamDef((ne, e, f), ("experts", "embed", "expert_ff"), contract=1, out=2),
        "wo": ParamDef((ne, f, e), ("experts", "expert_ff", "embed"), contract=1, out=2),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        defs["shared"] = {
            "wi_gate": ParamDef((e, fs), ("embed", "mlp"), contract=0, out=1),
            "wi_up": ParamDef((e, fs), ("embed", "mlp"), contract=0, out=1),
            "wo": ParamDef((fs, e), ("mlp", "embed"), contract=0, out=1),
        }
    return defs


def _router_probs(p, xt):
    return torch.softmax(proj(xt.float(), p["router"].float()), dim=-1)


def route(p, xt, k: int):
    """The top-k experts of each row of ``xt`` (T, E) and their
    renormalised probabilities, both (T, k), in the order ``lax.top_k``
    gives them: by probability, ties to the lower expert index (a stable
    sort, where ``torch.topk`` leaves ties in no stated order)."""
    probs = _router_probs(p, xt)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    if k == 1:  # p / p: 1 exactly, and its derivative 0 exactly
        return torch.ones_like(top_p[:, :1]), top_i[:, :1]
    top_p = top_p[:, :k]
    return top_p / top_p.sum(dim=-1, keepdim=True), top_i[:, :k]


class _Dispatch(torch.autograd.Function):
    """``xt[src]``: each token's row once per (token, expert) pair, in
    expert order. The backward takes the gradient's rows back to (token,
    k) order through ``inv`` and sums each token's k rows."""

    @staticmethod
    def forward(ctx, xt, src, inv, k):
        ctx.save_for_backward(inv)
        ctx.k = k
        return xt[src]

    @staticmethod
    def backward(ctx, d):
        (inv,) = ctx.saved_tensors
        return d[inv].unflatten(0, (-1, ctx.k)).sum(dim=1), None, None, None


class _Permute(torch.autograd.Function):
    """``y[perm]`` for a permutation; the backward is ``d[inv]``."""

    @staticmethod
    def forward(ctx, y, perm, inv):
        ctx.save_for_backward(inv)
        return y[perm]

    @staticmethod
    def backward(ctx, d):
        (inv,) = ctx.saved_tensors
        return d[inv], None, None


def routed_experts(p, xt, top_p, top_i, n_groups: int):
    """The routed experts' output (T, E) for the rows ``xt`` (T, E) and
    their picks ``top_i`` (T, k), each weighted by ``top_p``: the (token,
    k) pairs sorted by expert, three grouped GEMMs over ``n_groups``
    groups of ``p``'s experts, the rows back in (token, k) order, weighted
    and summed over k. Picks ``>= n_groups`` sort past the sum of the group
    sizes, where the kernel writes zeros (``parallel.moe_ep``'s other
    ranks' experts)."""
    t, e = xt.shape
    k = top_i.shape[1]
    # sort the (token, k) pairs by expert; order[j] is the pair at sorted row j
    expert, order = torch.sort(top_i.reshape(-1), stable=True)
    pairs = torch.arange(t * k, device=xt.device)
    inv = torch.empty_like(order).scatter_(0, order, pairs)
    xs = _Dispatch.apply(xt, order // k, inv, k)
    bounds = torch.searchsorted(expert, torch.arange(n_groups + 1, device=xt.device))
    group_sizes = bounds.diff().to(torch.int32)

    g = grouped_matmul(xs, p["wi_gate"].to(xs.dtype), group_sizes)
    u = grouped_matmul(xs, p["wi_up"].to(xs.dtype), group_sizes)
    h = F.silu(g) * u
    y_sorted = grouped_matmul(h, p["wo"].to(h.dtype), group_sizes)

    y = _Permute.apply(y_sorted, inv, order)  # (T*k, E) in (token, k) order
    return (y.reshape(t, k, e) * top_p[..., None].to(y.dtype)).sum(dim=1)


def add_shared(p, xt, y):
    """``y`` plus the shared experts' gated MLP of ``xt``, where ``p``
    has them."""
    if "shared" not in p:
        return y
    sp = p["shared"]
    return y + proj(F.silu(proj(xt, sp["wi_gate"])) * proj(xt, sp["wi_up"]), sp["wo"])


def moe_block(p, x, cfg):
    """x: (B, S, E) -> (B, S, E)."""
    b, s, e = x.shape
    xt = x.reshape(b * s, e)
    top_p, top_i = route(p, xt, cfg.top_k)
    y = routed_experts(p, xt, top_p, top_i, cfg.n_experts)
    return add_shared(p, xt, y).reshape(b, s, e).to(x.dtype)


def aux_load_balance_loss(p, x, cfg):
    """Switch-style load-balance term: n_experts * sum over experts of
    (share of tokens whose top-1 it is) x (mean router probability).
    The top-1 shares carry no gradient; it flows through the mean
    probabilities."""
    b, s, e = x.shape
    probs = _router_probs(p, x.reshape(b * s, e))
    frac_tokens = F.one_hot(probs.argmax(dim=-1), cfg.n_experts).float().mean(dim=0)
    return cfg.n_experts * (frac_tokens * probs.mean(dim=0)).sum()
