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

import functools

import torch
import torch.nn.functional as F

from ..kernels import grouped_matmul
from ..parallel import collectives as C
from .layers import ONE, Layout, mlp, proj
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


def _router_probs(p, xt, lay: Layout = ONE):
    """Softmax of the f32 router logits of the rows ``xt`` (T, E; split on
    E if ``lay.resid``): the whole (T, n_experts) on every rank."""
    logits = proj(xt.float(), p["router"].float(), None, lay, lay.dim("ffn", "router"),
                  lay.resid)
    return torch.softmax(logits, dim=-1)


def route(p, xt, k: int, lay: Layout = ONE):
    """The top-k experts of each row of ``xt`` (T, E) and their
    renormalised probabilities, both (T, k), in the order ``lax.top_k``
    gives them: by probability, ties to the lower expert index (a stable
    sort, where ``torch.topk`` leaves ties in no stated order)."""
    probs = _router_probs(p, xt, lay)
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


def routed_experts(p, xt, top_p, top_i, n_groups: int, lay: Layout = ONE):
    """The routed experts' output (T, E) for the rows ``xt`` (T, E) and
    their picks ``top_i`` (T, k), each weighted by ``top_p``: the (token,
    k) pairs sorted by expert, three grouped GEMMs over ``n_groups``
    groups of ``p``'s experts, the rows back in (token, k) order, weighted
    and summed over k. Picks ``>= n_groups`` sort past the sum of the group
    sizes, where the kernel writes zeros (``parallel.moe_ep``'s other
    ranks' experts). On a mesh (``lay``) xt and the output are split on E
    if ``lay.resid``, the hidden on expert_ff if ``lay.expert_hidden``."""
    t, e = xt.shape
    k = top_i.shape[1]
    # sort the (token, k) pairs by expert; order[j] is the pair at sorted row j
    expert, order = torch.sort(top_i.reshape(-1), stable=True)
    pairs = torch.arange(t * k, device=xt.device)
    inv = torch.empty_like(order).scatter_(0, order, pairs)
    xs = _Dispatch.apply(xt, order // k, inv, k)
    bounds = torch.searchsorted(expert, torch.arange(n_groups + 1, device=xt.device))
    group_sizes = bounds.diff().to(torch.int32)

    mm = functools.partial(grouped_matmul, group_sizes=group_sizes)

    def gmm(a, name, a_split, out_split):  # laid out as a dense GEMM (layers.proj)
        return proj(a, p[name], None, lay, lay.dim("ffn", name), a_split, out_split, mm)

    g = gmm(xs, "wi_gate", lay.resid, lay.expert_hidden)
    u = gmm(xs, "wi_up", lay.resid, lay.expert_hidden)
    h = F.silu(g) * u
    y_sorted = gmm(h, "wo", lay.expert_hidden, lay.resid)

    y = _Permute.apply(y_sorted, inv, order)  # (T*k, E) in (token, k) order
    if lay.resid:  # the weights, the same on every rank, meet this rank's slice of E
        top_p = C.copy_to(top_p, lay.mesh, lay.tp)
    return (y.reshape(t, k, -1) * top_p[..., None].to(y.dtype)).sum(dim=1)


def add_shared(p, xt, y, lay: Layout = ONE, hidden: bool = False):
    """``y`` plus the shared experts' gated MLP of ``xt``, where ``p``
    has them (on a mesh, ``layers.mlp``'s layout; ``hidden``: their
    hidden split over the tensor-parallel ranks)."""
    if "shared" not in p:
        return y
    return y + mlp(p["shared"], xt, lay, "shared", hidden)


def moe_block(p, x, cfg, lay: Layout = ONE):
    """x: (B, S, E) -> (B, S, E); on a mesh, this rank's rows, split on E
    if ``lay.resid``."""
    b, s, e = x.shape
    xt = x.reshape(b * s, e)
    top_p, top_i = route(p, xt, cfg.top_k, lay)
    y = routed_experts(p, xt, top_p, top_i, cfg.n_experts, lay)
    y = add_shared(p, xt, y, lay, lay.splits(cfg.expert_d_ff * cfg.n_shared_experts))
    return y.reshape(b, s, e).to(x.dtype)


def aux_load_balance_loss(p, x, cfg, lay: Layout = ONE):
    """Switch-style load-balance term: n_experts * sum over experts of
    (share of tokens whose top-1 it is) x (mean router probability).
    The top-1 shares carry no gradient; it flows through the mean
    probabilities. On a mesh x holds this rank's rows (split on E if
    ``lay.resid``): the term is not linear in the batch, so the top-1
    counts are summed over the batch axes before their product; the value
    is the global batch's on every rank, and each rank's gradient is its
    rows' share, as ``zoo.softmax_xent``'s."""
    b, s, e = x.shape
    probs = _router_probs(p, x.reshape(b * s, e), lay)
    top1 = F.one_hot(probs.argmax(dim=-1), cfg.n_experts).float()
    mesh = lay.mesh
    rows = b * s * C.axis_size(mesh, lay.batch)  # the global batch's
    # a batch that the data axes do not split is on every rank of them once
    copies = C.axis_size(mesh, lay.all_batch) // C.axis_size(mesh, lay.batch)
    frac = C.psum(top1.sum(dim=0), mesh, lay.batch) / rows
    local = cfg.n_experts * (frac * (probs.sum(dim=0) / rows)).sum() / copies
    return C.all_reduce(local, mesh, lay.all_batch)
