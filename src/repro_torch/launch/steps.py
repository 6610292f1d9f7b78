"""Step factories: train_step / prefill_step / serve_step.

The functions the training and serving loops call; they close over the
model and its config.

``make_train_step``: the loss and its gradients (torch autograd through
the kernels' Functions), then one AdamW update. ``microbatches > 1``
turns the step into gradient accumulation (``accumulate_grads``), as in
the reference: the
batch is split along its leading dim, each part's gradients are summed
in f32, and the sums and the loss are divided by the count before the
one update.

Under sharding rules (``parallel.axes.use_rules``) on a mesh of several
ranks the step takes this rank's shards of the params and moments and the
global batch: the gradients are summed over the batch axes, and the clip
reads the global norm of the shards (``optim.adamw.global_norm``).
"""

from __future__ import annotations

import torch

from ..models.params import leaves, map_tree, unflatten
from ..optim import OptConfig, adamw_update

__all__ = ["loss_and_grads", "accumulate_grads", "make_train_step", "make_prefill_step",
           "make_serve_step"]


def loss_and_grads(model, params, batch, remat):
    """``(loss, grads)``: the loss (a 0-d f32 tensor) and its gradient
    tree with respect to ``params``. Under sharding rules (``use_rules``)
    on a mesh, ``params`` are this rank's shards, ``batch`` the global
    batch, and the gradients this rank's shards of the global batch's."""
    loss, grads = _loss_and_grads(model, params, batch, remat)
    return loss, model.layout(batch["tokens"].shape[0]).reduce_grads(grads)


def _loss_and_grads(model, params, batch, remat):
    pairs = [(path, t.detach().requires_grad_(True)) for path, t in leaves(params)]
    with torch.enable_grad():
        loss = model.loss(unflatten(pairs), batch, remat=remat)
        grads = torch.autograd.grad(loss, [t for _, t in pairs])
    return loss.detach(), unflatten((path, g) for (path, _), g in zip(pairs, grads))


def accumulate_grads(model, params, batch, remat, microbatches):
    """``(loss, grads)`` of ``batch`` split along its leading dim into
    ``microbatches`` parts: the parts' gradients summed in f32, then the
    sums and the loss divided by the count."""
    mb = microbatches
    b = batch["tokens"].shape[0]
    if b % mb:
        raise ValueError(f"batch {b} does not split into {mb} microbatches")
    parts = [{k: x[i * (b // mb):(i + 1) * (b // mb)] for k, x in batch.items()}
             for i in range(mb)]
    gsum = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
    lsum = torch.zeros((), dtype=torch.float32, device=model.device)
    for part in parts:
        loss, grads = _loss_and_grads(model, params, part, remat)
        gsum = unflatten((path, a + g.float())
                         for (path, a), (_, g) in zip(leaves(gsum), leaves(grads)))
        lsum = lsum + loss
    return lsum / mb, model.layout(b).reduce_grads(map_tree(lambda g: g / mb, gsum))


def make_train_step(model, opt_cfg: OptConfig, *, remat=True, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: batch holds ``tokens`` and ``labels`` (B, S). The step
    updates the params and moments it is given in place (the reference's
    ``donate_argnums=(0, 1)``); a caller that needs the old ones clones
    them first."""
    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = loss_and_grads(model, params, batch, remat)
        else:
            loss, grads = accumulate_grads(model, params, batch, remat, microbatches)
        lay = model.layout(batch["tokens"].shape[0])
        shards = None if lay.mesh is None else (lay.mesh, lay.specs)
        new_params, new_opt, _ = adamw_update(params, grads, opt_state, opt_cfg, shards=shards)
        return new_params, new_opt, loss

    return train_step


def make_prefill_step(model, *, max_len: int = 0):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len=max_len)

    return prefill_step


def make_serve_step(model):
    def serve_step(params, cache, batch):
        return model.decode(params, cache, batch)

    return serve_step
