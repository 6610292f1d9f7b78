"""Model facade: one ``Model`` per architecture config, bound to a device.

    model = build(cfg)                      # cuda unless device="cpu"
    params = model.compute_params(model.init(torch.Generator().manual_seed(0)))
    logits, cache = model.prefill(params, {"tokens": tokens}, max_len=...)
    logits, cache = model.decode(params, cache, {"token": tok})
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .._device import resolve_device
from ..config import ArchConfig
from .decoder import decoder_defs, decoder_forward, init_cache
from .params import materialize, tree_size

__all__ = ["Model", "build"]

# Leaves the reference reads in f32: the norm scales (rmsnorm), and
# Mamba2's A, dt_bias and its gated-norm scale ``norm`` (ssm.py).
_FLOAT_LEAVES_KEPT = ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "A", "dt_bias", "norm")


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
        scales, Mamba2's ``A`` and ``dt_bias``) stay as they are. The
        reference casts the same weights to the same values on every
        call."""
        dtype = getattr(torch, self.cfg.compute_dtype)

        def cast(tree, name=None):
            if isinstance(tree, dict):
                return {k: cast(v, k) for k, v in tree.items()}
            return tree if name in _FLOAT_LEAVES_KEPT else tree.to(dtype)

        return cast(params)

    @property
    def n_params(self) -> int:
        return tree_size(self.defs)

    # ---- forward ------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch, *, max_len: int = 0):
        return decoder_forward(params, batch["tokens"].to(self.device), self.cfg,
                               mode="prefill", max_len=max_len)

    @torch.no_grad()
    def decode(self, params, cache, batch):
        """One serve step: batch["token"] (B, 1) -> logits (B, 1, V)."""
        return decoder_forward(params, batch["token"].to(self.device), self.cfg,
                               mode="decode", cache=cache)

    # ---- caches -----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return init_cache(self.cfg, batch, max_len, dtype, self.device)


def build(cfg: ArchConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (default ``cuda``; raises
    without a card unless ``device="cpu"``)."""
    return Model(cfg=cfg, defs=decoder_defs(cfg), device=resolve_device(device))
