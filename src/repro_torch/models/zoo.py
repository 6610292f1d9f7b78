"""Model facade: one ``Model`` per architecture config, bound to a device.
Every family of the zoo is ported: dense, MoE, vision cross-attention
(vlm), hybrid and SSM (xLSTM) through ``models/decoder.py``, the
encoder-decoder (whisper) through ``models/encdec.py``.

    model = build(cfg)                      # cuda unless device="cpu"
    master = model.init(torch.Generator().manual_seed(0))   # param_dtype (f32)
    loss = model.loss(master, {"tokens": t, "labels": y})   # train: differentiable
    params = model.compute_params(master)   # serving: cast once
    params = model.init_compute(gen)        # the same, a leaf at a time
    logits, cache = model.prefill(params, {"tokens": tokens}, max_len=...)
    logits, cache = model.decode(params, cache, {"token": tok})

The vision model's train and prefill batches also hold ``image_embeds``
(B, n_image_tokens, E), whisper's ``enc_frames`` (B, enc_seq, E); a
decode step reads what they gave from the cache.

Under sharding rules (``parallel.axes.use_rules``) on a mesh of more
than one rank, ``loss``, ``prefill``, ``decode`` and ``greedy`` take this
rank's shards of the parameters and the global batch (its image
embeddings or frames too), and run every family's forward on them
(``Model.layout``: the layers' ``Layout``). With no rules, or on a mesh
of one rank, they run as one device does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .._device import resolve_device
from ..config import ArchConfig
from ..launch.mesh import mesh_size
from ..parallel import collectives as C
from ..parallel.axes import current_rules
from .decoder import decoder_defs, decoder_forward, init_cache, layout
from .encdec import encdec_defs, encdec_forward, encdec_init_cache
from .layers import ONE, Layout, embed_tokens
from .moe import aux_load_balance_loss
from .params import compute_cast, materialize, materialize_cast, tree_size

__all__ = ["MODEL_INPUTS", "Model", "build", "softmax_xent", "spans_ranks"]

# the input that a family's train and prefill batches hold beside the
# tokens, and the config field that gives its length
MODEL_INPUTS = {"vlm": ("image_embeds", "n_image_tokens"), "encdec": ("enc_frames", "enc_seq")}


def spans_ranks(cfg: ArchConfig, rules) -> bool:
    """Whether ``rules`` span more than one rank (every family of the zoo
    runs sharded there)."""
    del cfg
    return rules is not None and mesh_size(rules.mesh) > 1


def softmax_xent(logits, labels, lay: Layout = ONE):
    """Mean next-token cross-entropy; logits f32 (B, S, V). On a mesh
    (``lay``) the logits are this rank's rows (and vocab slice): the
    log-softmax over a sharded vocab takes a max, a sum of exponentials
    and the target's logit from its owner, each all-reduced; each rank's
    mean is a share of the global mean, summed over the batch axes."""
    if lay.mesh is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, labels[..., None].long())[..., 0]
        return -ll.mean()
    labels = labels.long()
    if lay.vocab:
        nll = _vocab_parallel_nll(lay, logits, labels)
    else:
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
    nb = C.axis_size(lay.mesh, lay.all_batch)
    return C.all_reduce(nll.mean() / nb, lay.mesh, lay.all_batch)


def _vocab_parallel_nll(lay: Layout, logits, labels):
    mesh, tp = lay.mesh, lay.tp
    top = C.all_reduce_max(logits.amax(dim=-1), mesh, tp)
    sumexp = C.all_reduce(torch.exp(logits - top[..., None]).sum(dim=-1), mesh, tp)
    v = logits.shape[-1]
    local = labels - C.axis_index(mesh, tp) * v
    mine = (local >= 0) & (local < v)
    picked = logits.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
    target = C.all_reduce(torch.where(mine, picked, 0.0), mesh, tp)
    return torch.log(sumexp) + top - target


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    defs: Any  # ParamDef tree
    device: torch.device

    # ---- parameters -----------------------------------------------------
    def init(self, generator: torch.Generator, dtype=None, place=None):
        """Parameters in ``param_dtype`` on the model's device. Drawn on
        the generator's device, so a CPU generator gives the same weights
        on the CPU and on the card. ``place(path, leaf)`` cuts each leaf
        to this rank's shard before the move (``materialize``)."""
        dtype = dtype or getattr(torch, self.cfg.param_dtype)
        return materialize(self.defs, generator, dtype, self.device, place)

    def compute_params(self, params):
        """The parameter tree with every GEMM weight, bias, Mamba2's
        ``conv_w`` and ``D`` and the embedding table cast once to the
        compute dtype; the leaves the reference reads in f32 (norm
        scales, Mamba2's ``A`` and ``dt_bias``, the xLSTM's forget-gate
        biases ``bf`` and sLSTM recurrent weights ``r``, the MoE router,
        the vision cross layers' ``gate``) stay as they are. The
        reference casts the same weights to the same values on every
        call."""
        return compute_cast(params, getattr(torch, self.cfg.compute_dtype))

    def init_compute(self, generator: torch.Generator, place=None):
        """``compute_params(init(generator))``, bit for bit, formed one
        leaf at a time (drawn on the generator's device, cut by ``place``,
        moved, cast), so that serving never holds the f32 tree on the
        device."""
        return materialize_cast(self.defs, generator, getattr(torch, self.cfg.param_dtype),
                                getattr(torch, self.cfg.compute_dtype), self.device, place)

    @property
    def n_params(self) -> int:
        return tree_size(self.defs)

    # ---- forward ------------------------------------------------------------
    def layout(self, batch: int | None = None) -> Layout:
        """This rank's layout under the active sharding rules, for a global
        batch of ``batch`` rows: ``ONE`` with no rules or on a mesh of one
        rank."""
        rules = current_rules()
        if not spans_ranks(self.cfg, rules):
            return ONE
        return layout(self.cfg, rules, batch)

    def _forward(self, params, tokens, *, mode, cache=None, batch=None, max_len=0,
                 remat=False, lay=ONE):
        batch = batch or {}
        tokens = lay.batch_slice(tokens.to(self.device))
        extra = None
        if self.cfg.family in MODEL_INPUTS and MODEL_INPUTS[self.cfg.family][0] in batch:
            # this rank's rows, split on E as the residual is
            extra = lay.batch_slice(batch[MODEL_INPUTS[self.cfg.family][0]].to(self.device))
            if lay.resid:
                extra = C.local_slice(extra, lay.mesh, lay.tp, -1)
        if self.cfg.family == "encdec":
            return encdec_forward(params, tokens, self.cfg, mode=mode, cache=cache,
                                  enc_frames=extra, max_len=max_len, remat=remat, lay=lay)
        return decoder_forward(params, tokens, self.cfg, mode=mode, cache=cache,
                               image_embeds=extra, max_len=max_len, remat=remat, lay=lay)

    def loss(self, params, batch, *, remat=False):
        """Mean next-token cross-entropy of batch["tokens"] against
        batch["labels"] (B, S), differentiable in ``params`` (the f32
        masters: each GEMM casts its weight to the compute dtype).
        ``remat``: False, True (recompute each layer in the backward) or
        ``"save_gathered"`` (recompute it, keeping the cast weights). An
        MoE model adds 0.01 x the load-balance term of its first layer's
        router on the tokens' raw embeddings, as the reference does.

        On a mesh, ``params`` are this rank's shards and ``batch`` the global
        batch: the value is the same on every rank, and each rank's
        gradient is that of its rows' share (their mean over the batch
        axes' rank count), so summed over the batch axes it is the global
        mean's (``Layout.reduce_grads``)."""
        tokens = batch["tokens"].to(self.device)
        lay = self.layout(tokens.shape[0])
        logits, _ = self._forward(params, tokens, mode="train", batch=batch, remat=remat,
                                  lay=lay)
        loss = softmax_xent(logits, lay.batch_slice(batch["labels"].to(self.device)), lay)
        if self.cfg.family == "moe":
            # this rank's rows, from its shard of the table
            x = embed_tokens(lay.gather(params["embed"], "embed"), lay.batch_slice(tokens),
                             torch.float32, lay)
            router = {"router": lay.gather(params["layers"]["ffn"]["router"][0],
                                           ("layers", "ffn", "router"))}
            loss = loss + 0.01 * aux_load_balance_loss(router, x, self.cfg, lay)
        return loss

    @torch.no_grad()
    def prefill(self, params, batch, *, max_len: int = 0):
        """The prompt's logits and the cache. On a mesh: this rank's rows
        of the logits (and its vocab slice) and its shard of the cache."""
        lay = self.layout(batch["tokens"].shape[0])
        return self._forward(params, batch["tokens"], mode="prefill", batch=batch,
                             max_len=max_len, lay=lay)

    @torch.no_grad()
    def decode(self, params, cache, batch):
        """One serve step: batch["token"] (B, 1) -> logits (B, 1, V); on a
        mesh, the global batch's token -> this rank's logits."""
        lay = self.layout(cache.get("batch"))
        return self._forward(params, batch["token"], mode="decode", cache=cache, lay=lay)

    def greedy(self, logits, cache):
        """The greedy tokens (B, 1) of logits (B, 1, V) that ``prefill``
        (its last position) or ``decode`` gave with ``cache``: their argmax.
        On a mesh, the global batch's from this rank's shards: over a
        sharded vocab each rank's first maximum and its value are
        gathered, and the largest wins, the lowest index among equals (the
        first index of the maximum, as ``torch.argmax``); then the batch's
        rows are gathered."""
        lay = self.layout(cache.get("batch"))
        if lay.vocab and lay.m > 1:
            mesh = lay.mesh
            val, idx = logits.max(dim=-1)  # the first maximum of this slice
            idx = idx + C.axis_index(mesh, lay.tp) * logits.shape[-1]
            vals = C.gather(val[..., None], mesh, lay.tp, -1)
            idxs = C.gather(idx[..., None], mesh, lay.tp, -1)
            best = vals.argmax(dim=-1, keepdim=True)  # the lowest rank holding the maximum
            tok = idxs.gather(-1, best)[..., 0]
        else:
            tok = logits.argmax(dim=-1)
        return C.gather(tok, lay.mesh, lay.batch, 0)

    # ---- caches -----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        fn = encdec_init_cache if self.cfg.family == "encdec" else init_cache
        return fn(self.cfg, batch, max_len, dtype, self.device)


def build(cfg: ArchConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (default ``cuda``; raises
    without a card unless ``device="cpu"``)."""
    defs = encdec_defs(cfg) if cfg.family == "encdec" else decoder_defs(cfg)
    return Model(cfg=cfg, defs=defs, device=resolve_device(device))
