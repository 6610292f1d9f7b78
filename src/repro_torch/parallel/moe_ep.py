"""Expert-parallel MoE FFN, the counterpart of the JAX package's
``parallel/moe_ep.py``.

Fine-grained MoE (deepseek: 64 experts of 1,408 hidden units) keeps
its experts whole but spread over the ``model`` axis, and moves tokens
to them instead of gathering weights:

- each rank routes its rows (the rows of its ``batch_axis`` slot) in f32
  through the replicated router (``models.moe.route``: ``lax.top_k``'s
  order, ties to the lower expert);
- picks of experts that another rank holds go to an overflow bucket
  with zero weight;
- the rank's ``ne_local`` experts run through ``moe_block``'s own
  ``models.moe.routed_experts``: three grouped GEMMs over the sorted rows
  (``kernels.grouped_matmul``), the rows back in (token, k) order,
  weighted and summed over k. The reference multiplies the overflow rows
  by an appended zero expert; the kernel already gives zeros for rows
  past the sum of the group sizes, so the port passes the real groups
  only and skips those products;
- ``y`` is summed over ``axis`` (each rank contributes the experts it
  holds), then the shared experts are added (``models.moe.add_shared``).

The group sizes are counted on the device, as in ``moe_block``, so a
decode step does not wait for the host. Gradients follow
``collectives``' convention: the router and the rows that enter the
expert path are replicated inputs to a rank-local computation
(``copy_to``: their gradients summed over ``axis``); the shared experts
run after the sum, identically on every rank, so their path is not
summed again. At one rank on ``axis`` this is ``moe_block`` bit for bit.

Wire cost per layer: one all-reduce of the rows' outputs (tokens x E),
whatever the experts' size.
"""

from __future__ import annotations

import torch

from ..models.moe import add_shared, route, routed_experts
from . import collectives as C

__all__ = ["expert_shard", "moe_block_ep"]

_EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")


def expert_shard(p, mesh, axis: str = "model"):
    """This rank's tree of a full ``moe_defs`` tree: its slice of the
    experts of each expert leaf (a copy), the router and the shared experts
    as they are."""
    n, i = C.axis_size(mesh, axis), C.axis_index(mesh, axis)
    return {k: (v.chunk(n, dim=0)[i].clone() if k in _EXPERT_LEAVES else v) for k, v in p.items()}


def moe_block_ep(p, x, cfg, mesh, *, axis: str = "model", batch_axis: str | None = "data"):
    """Expert-parallel MoE FFN. p: this rank's ``moe_defs`` tree
    (``expert_shard``: its ``n_experts / size`` experts of each expert
    leaf); x: (B, S, E), the global rows, replicated. Returns this rank's
    rows along ``batch_axis``, (B / size, S, E)."""
    ne, size = cfg.n_experts, C.axis_size(mesh, axis)
    if ne % size:
        raise ValueError(f"{ne} experts do not split over {size} ranks")
    ne_local = ne // size
    if p["wi_gate"].shape[0] != ne_local:
        raise ValueError(f"p holds {p['wi_gate'].shape[0]} experts; a rank of {size} holds "
                         f"{ne_local} (expert_shard)")
    x = C.local_slice(x, mesh, batch_axis, 0)
    b, s, e = x.shape
    t, k = b * s, cfg.top_k
    xt = x.reshape(t, e)
    xe = C.copy_to(xt, mesh, axis)
    top_p, top_i = route({"router": C.copy_to(p["router"], mesh, axis)}, xe, k)

    # local expert ids in [0, ne_local); picks of other ranks' experts go to
    # the overflow bucket ne_local, past the sum of the group sizes
    local = top_i - C.axis_index(mesh, axis) * ne_local
    mine = (local >= 0) & (local < ne_local)
    local = torch.where(mine, local, ne_local)
    w_local = torch.where(mine, top_p, 0.0)
    y = C.all_reduce(routed_experts(p, xe, w_local, local, ne_local), mesh, axis)
    return add_shared(p, xt, y).reshape(b, s, e).to(x.dtype)
