"""GPipe pipeline parallelism over a mesh's stage axis, the counterpart of
the JAX package's ``parallel/pipeline.py``.

The dense decoder's layer stack is split into ``n_stages`` contiguous
stages, one per rank along ``stage_axis``, and ``n_microbatches``
microbatches flow through ``n_mb + n_stages - 1`` ticks: stage 0 embeds,
each stage runs its layers (``decoder._train_block``, each layer
recomputed in the backward under ``remat``), the last stage applies the
final norm, the unembedding and ``softmax_xent``, and activations move
one stage forward per tick. The loss is the sum of the microbatch means,
in order, over ``n_mb``; the last stage broadcasts it, so every rank
returns the same value.

The reference differentiates its ``shard_map`` loop (the backward's
handoffs are ``ppermute``'s transpose) and computes every stage on every
tick, masking the bubble ticks' results. Point-to-point sends in torch
are not autograd-aware, so one ``torch.autograd.Function`` runs the whole
schedule: its forward runs the forward ticks and keeps each microbatch's
graph (the stage's input and output); its backward runs the ticks in
reverse, receiving dY from the next stage, back-propagating through the
stage and sending dX to the previous one. A stage computes only on the
ticks that hold one of its microbatches, which gives the same result.
Each tick's sends and receives are posted together
(``collectives.send_recv``), so two neighbours never both block.

Each rank holds and differentiates its stage's slice of every ``layers``
leaf (``stage_params`` cuts a full tree: the reference's ``P(stage_axis)``)
and the embedding and final norm, which are replicated. Their gradients
(stage 0's gather plus the last stage's tied unembedding; the last
stage's norm) are summed over the stage axis, so every rank holds the
whole gradient: the replicated-input rule of ``collectives.copy_to``.
The bubble's share of the ticks is ``bubble_fraction``.

This path implements the dense family, as the reference's does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.decoder import _train_block, layer_metadata
from ..models.layers import embed_tokens, rmsnorm, unembed
from ..models.params import leaves, map_tree, unflatten
from ..models.zoo import softmax_xent
from . import collectives as C

__all__ = ["bubble_fraction", "make_gpipe_loss", "stage_params"]

_REPLICATED = ("embed", "final_norm")  # the roots every stage holds whole


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """The share of a stage's ticks that hold no microbatch."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def _per_stage(cfg, n_stages: int) -> int:
    if cfg.family != "dense":
        raise ValueError(f"the pipeline implements the dense family; {cfg.name} is "
                         f"{cfg.family!r}")
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into {n_stages} stages")
    return cfg.n_layers // n_stages


def stage_params(params, cfg, mesh, *, n_stages: int, stage_axis: str = "pod"):
    """This rank's stage tree of a full parameter tree: its stage's
    ``n_layers / n_stages`` layers of every ``layers`` leaf (a copy), and
    the embedding and the final norm as they are."""
    per = _per_stage(cfg, n_stages)
    lo = C.axis_index(mesh, stage_axis) * per
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers": map_tree(lambda a: a[lo:lo + per].clone(), params["layers"])}


def make_gpipe_loss(cfg, mesh, *, n_stages: int, n_microbatches: int, stage_axis: str = "pod",
                    remat: bool = True):
    """``loss_fn(params, batch)`` running the GPipe schedule.

    params: this rank's stage tree (``stage_params``). batch: ``{"tokens":
    (B, S), "labels": (B, S)}``, the global batch on every rank, with
    ``B % n_microbatches == 0``. Differentiable in ``params``: each rank's
    layer gradients are its stage's, the embedding's and final norm's the
    whole model's."""
    per = _per_stage(cfg, n_stages)
    if C.axis_size(mesh, stage_axis) != n_stages:
        raise ValueError(f"{n_stages} stages on a {stage_axis!r} axis of "
                         f"{C.axis_size(mesh, stage_axis)} ranks")
    wins, thetas = layer_metadata(cfg)
    if n_stages > 1 and dist.get_backend(C.axis_group(mesh, stage_axis)) == "nccl":
        # join the stage group's communicator on every rank before the first
        # point-to-point handoff, which only two of them post
        C.psum(torch.zeros(1, device=torch.cuda.current_device()), mesh, stage_axis)

    def loss_fn(params, batch):
        stage = C.axis_index(mesh, stage_axis)
        lo = stage * per
        sched = _Schedule(cfg, mesh, stage_axis, stage, n_stages, n_microbatches, remat,
                          wins[lo:lo + per], thetas[lo:lo + per], batch)
        paths, flat = zip(*leaves(params))
        need = torch.is_grad_enabled() and any(t.requires_grad for t in flat)
        return _GPipe.apply(sched, paths, need, *flat)

    return loss_fn


class _Schedule:
    """One call's forward ticks and, after them, its backward ticks."""

    def __init__(self, cfg, mesh, axis, stage, n_stages, n_mb, remat, wins, thetas, batch):
        self.cfg, self.mesh, self.axis, self.remat = cfg, mesh, axis, remat
        self.stage, self.last, self.n_mb = stage, n_stages - 1, n_mb
        self.n_ticks = n_mb + n_stages - 1
        self.wins, self.thetas = wins, thetas
        b, s = batch["tokens"].shape
        if b % n_mb:
            raise ValueError(f"a batch of {b} rows does not split into {n_mb} microbatches")
        self.tokens = batch["tokens"].reshape(n_mb, b // n_mb, s)
        self.labels = batch["labels"].reshape(n_mb, b // n_mb, s)
        self.inputs, self.outputs = [None] * n_mb, [None] * n_mb

    def _handoff(self, like, send, send_to, recv, recv_from):
        return C.send_recv(self.mesh, self.axis,
                           [(send, send_to)] if send is not None else [],
                           [(like, recv_from)] if recv else [])

    def forward(self, tree, grad: bool):
        cfg, s, last = self.cfg, self.stage, self.last
        emb, fin = tree["embed"], tree["final_norm"]
        dev = emb["tok"].device
        tokens, labels = self.tokens.to(dev), self.labels.to(dev)
        dtype = getattr(torch, cfg.compute_dtype)
        self.like = torch.empty((*tokens.shape[1:], cfg.d_model), dtype=dtype, device=dev)
        # one unbind per stacked leaf, as decoder._dense_layers does
        stacked = map_tree(lambda a: a.unbind(0), tree["layers"])
        lps = [map_tree(lambda a, i=i: a[i], stacked) for i in range(len(self.wins))]
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        y_prev = None
        for t in range(self.n_ticks):
            m = t - s  # this stage's microbatch on tick t
            valid = 0 <= m < self.n_mb
            got = self._handoff(self.like, y_prev, s + 1, s > 0 and valid, s - 1)
            y_prev = None
            if not valid:
                continue
            x = embed_tokens(emb, tokens[m], dtype) if s == 0 else got[0].requires_grad_(grad)
            y = x
            for i, lp in enumerate(lps):
                y = _train_block(lp, y, cfg, window=self.wins[i], theta=self.thetas[i],
                                 remat=self.remat)
            if s == last:
                logits = unembed(emb, rmsnorm(y, fin, cfg.norm_eps), cfg.tie_embeddings)
                y = softmax_xent(logits, labels[m])
                loss = loss + y.detach()
            else:
                y_prev = y.detach()
            if grad:
                self.inputs[m], self.outputs[m] = x, y
        return C.broadcast(loss / self.n_mb, self.mesh, self.axis, last)

    def backward(self, g):
        s, last = self.stage, self.last
        dx_prev = None
        for u in range(self.n_ticks):
            m = self.n_mb - 1 - u + (last - s)  # microbatches in reverse, the last stage first
            valid = 0 <= m < self.n_mb
            got = self._handoff(self.like, dx_prev, s - 1, s < last and valid, s + 1)
            dx_prev = None
            if not valid:
                continue
            dy = g / self.n_mb if s == last else got[0]
            torch.autograd.backward(self.outputs[m], dy)
            if s > 0:
                dx_prev = self.inputs[m].grad
            self.inputs[m] = self.outputs[m] = None


class _GPipe(torch.autograd.Function):
    """The schedule over this rank's parameter leaves: forward the loss,
    backward each leaf's gradient (the replicated roots' summed over the
    stage axis)."""

    @staticmethod
    def forward(ctx, sched, paths, grad, *flat):
        with torch.set_grad_enabled(grad):
            det = [t.detach().requires_grad_(t.requires_grad) for t in flat]
            loss = sched.forward(unflatten(zip(paths, det)), grad)
        ctx.sched, ctx.paths, ctx.det = sched, paths, det
        return loss

    @staticmethod
    def backward(ctx, g):
        sched = ctx.sched
        with torch.enable_grad():
            sched.backward(g)
        grads = []
        for path, d in zip(ctx.paths, ctx.det):
            gd = d.grad
            if path[0] in _REPLICATED and d.requires_grad:
                gd = C.psum(torch.zeros_like(d) if gd is None else gd, sched.mesh, sched.axis)
            grads.append(gd)
        return (None, None, None, *grads)
