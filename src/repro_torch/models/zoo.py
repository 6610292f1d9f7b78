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
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..config import ArchConfig
from .decoder import decoder_defs, decoder_forward, init_cache
from .encdec import encdec_defs, encdec_forward, encdec_init_cache
from .moe import aux_load_balance_loss
from .params import compute_cast, materialize, materialize_cast, tree_size

__all__ = ["MODEL_INPUTS", "Model", "build", "softmax_xent"]

# the input that a family's train and prefill batches hold beside the
# tokens, and the config field that gives its length
MODEL_INPUTS = {"vlm": ("image_embeds", "n_image_tokens"), "encdec": ("enc_frames", "enc_seq")}


def softmax_xent(logits, labels):
    """Mean next-token cross-entropy; logits f32 (B, S, V)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    return -ll.mean()


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    defs: Any  # ParamDef tree
    device: torch.device

    # ---- parameters -----------------------------------------------------
    def init(self, generator: torch.Generator, dtype=None):
        """Parameters in ``param_dtype`` on the model's device. Drawn on
        the generator's device, so a CPU generator gives the same weights
        on the CPU and on the card."""
        dtype = dtype or getattr(torch, self.cfg.param_dtype)
        return materialize(self.defs, generator, dtype, self.device)

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

    def init_compute(self, generator: torch.Generator):
        """``compute_params(init(generator))``, bit for bit, formed one
        leaf at a time (drawn on the generator's device, moved, cast), so
        that serving never holds the f32 tree on the device."""
        return materialize_cast(self.defs, generator, getattr(torch, self.cfg.param_dtype),
                                getattr(torch, self.cfg.compute_dtype), self.device)

    @property
    def n_params(self) -> int:
        return tree_size(self.defs)

    # ---- forward ------------------------------------------------------------
    def _forward(self, params, tokens, *, mode, cache=None, batch=None, max_len=0,
                 remat=False):
        batch = batch or {}
        tokens = tokens.to(self.device)
        if self.cfg.family == "encdec":
            frames = batch.get("enc_frames")
            return encdec_forward(params, tokens, self.cfg, mode=mode, cache=cache,
                                  enc_frames=None if frames is None else frames.to(self.device),
                                  max_len=max_len, remat=remat)
        image = batch.get("image_embeds")
        return decoder_forward(params, tokens, self.cfg, mode=mode, cache=cache,
                               image_embeds=None if image is None else image.to(self.device),
                               max_len=max_len, remat=remat)

    def loss(self, params, batch, *, remat=False):
        """Mean next-token cross-entropy of batch["tokens"] against
        batch["labels"] (B, S), differentiable in ``params`` (the f32
        masters: each GEMM casts its weight to the compute dtype).
        ``remat``: False, True (recompute each layer in the backward) or
        ``"save_gathered"`` (recompute it, keeping the cast weights). An
        MoE model adds 0.01 x the load-balance term of its first layer's
        router on the tokens' raw embeddings, as the reference does."""
        tokens = batch["tokens"].to(self.device)
        logits, _ = self._forward(params, tokens, mode="train", batch=batch, remat=remat)
        loss = softmax_xent(logits, batch["labels"].to(self.device))
        if self.cfg.family == "moe":
            x = F.embedding(tokens, params["embed"]["tok"]).float()
            router = {"router": params["layers"]["ffn"]["router"][0]}
            loss = loss + 0.01 * aux_load_balance_loss(router, x, self.cfg)
        return loss

    @torch.no_grad()
    def prefill(self, params, batch, *, max_len: int = 0):
        return self._forward(params, batch["tokens"], mode="prefill", batch=batch,
                             max_len=max_len)

    @torch.no_grad()
    def decode(self, params, cache, batch):
        """One serve step: batch["token"] (B, 1) -> logits (B, 1, V)."""
        return self._forward(params, batch["token"], mode="decode", cache=cache)

    # ---- caches -----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        fn = encdec_init_cache if self.cfg.family == "encdec" else init_cache
        return fn(self.cfg, batch, max_len, dtype, self.device)


def build(cfg: ArchConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (default ``cuda``; raises
    without a card unless ``device="cpu"``)."""
    defs = encdec_defs(cfg) if cfg.family == "encdec" else decoder_defs(cfg)
    return Model(cfg=cfg, defs=defs, device=resolve_device(device))
