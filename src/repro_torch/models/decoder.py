"""Decoder LM, dense branch (llama/smollm/qwen and gemma3's local:global).

The reference scans a stacked layer tree with ``lax.scan`` and carries
each layer's window and rope theta as scanned arrays. The port keeps the
stacked parameter layout (``layers.wq`` is (L, E, H*hd), and so on) but
runs the layers in a Python loop, so each layer's window and theta are
Python numbers: the window reaches the flash kernel as a launch
argument. The other families raise ``NotImplementedError`` naming their
ROADMAP item.

Modes: ``prefill`` (whole prompt; returns the KV cache) and ``decode``
(one token; the cache advances in place).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ArchConfig
from .layers import (
    attention, attn_defs, embed_defs, embed_tokens, mlp, mlp_defs, rmsnorm,
    rmsnorm_def, unembed,
)
from .params import map_tree, stack_defs

__all__ = ["decoder_defs", "decoder_forward", "init_cache", "layer_metadata"]

_GLOBAL_WINDOW = 2**30  # "window" larger than any sequence = global attn

_NOT_PORTED = {
    "moe": "ROADMAP queue 1 item 9",
    "vlm": "ROADMAP queue 1 item 9",
    "encdec": "ROADMAP queue 1 item 9",
    "hybrid": "ROADMAP queue 1 item 8",
    "ssm": "ROADMAP queue 1 item 8",
}


def _check_family(cfg: ArchConfig):
    if cfg.family != "dense":
        where = _NOT_PORTED.get(cfg.family, "no ROADMAP item")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch: {where}"
        )


def _block_defs(cfg: ArchConfig):
    return {
        "ln1": rmsnorm_def(cfg.d_model),
        "attn": attn_defs(cfg),
        "ln2": rmsnorm_def(cfg.d_model),
        "ffn": mlp_defs(cfg),
    }


def decoder_defs(cfg: ArchConfig):
    _check_family(cfg)
    return {
        "embed": embed_defs(cfg),
        "final_norm": rmsnorm_def(cfg.d_model),
        "layers": stack_defs(_block_defs(cfg), cfg.n_layers),
    }


def layer_metadata(cfg: ArchConfig, n: int | None = None):
    """Per-layer (window, theta) lists."""
    n = n or cfg.n_layers
    wins, thetas = [], []
    for i in range(n):
        is_global = cfg.global_every and ((i + 1) % cfg.global_every == 0)
        if cfg.sliding_window and not is_global:
            wins.append(cfg.sliding_window)
        else:
            wins.append(_GLOBAL_WINDOW)
        if is_global and cfg.global_rope_theta:
            thetas.append(float(cfg.global_rope_theta))
        else:
            thetas.append(float(cfg.rope_theta))
    return wins, thetas


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Decode-ready cache: stacked (L, B, max_len, KVH, D) k/v buffers and
    one ``length`` for all layers (the reference keeps a copy per layer)."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "layers": {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        },
        "length": 0,
    }


def _attn_mlp_block(lp, x, cfg, *, mode, cache, window, theta):
    h, new_cache = attention(
        lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
        mode=mode, cache=cache, window=window, theta=theta,
    )
    x = x + h
    return x + mlp(lp["ffn"], rmsnorm(x, lp["ln2"], cfg.norm_eps)), new_cache


def decoder_forward(params, tokens, cfg: ArchConfig, *, mode: str, cache=None,
                    max_len: int = 0):
    """tokens (B, S) int -> (logits (B, S, V) f32, new cache)."""
    _check_family(cfg)
    x = embed_tokens(params["embed"], tokens, getattr(torch, cfg.compute_dtype))
    wins, thetas = layer_metadata(cfg)
    ks, vs = [], []  # prefill: each layer's new k, v
    for i in range(cfg.n_layers):
        lp = map_tree(lambda a: a[i], params["layers"])
        cache_l = None
        if mode == "decode":
            cache_l = {"k": cache["layers"]["k"][i], "v": cache["layers"]["v"][i],
                       "length": cache["length"]}
        x, nc = _attn_mlp_block(lp, x, cfg, mode=mode, cache=cache_l,
                                window=wins[i], theta=thetas[i])
        if mode == "prefill":
            ks.append(nc["k"])
            vs.append(nc["v"])

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tie_embeddings)

    if mode == "decode":
        return logits, {"layers": cache["layers"], "length": cache["length"] + 1}
    new_cache = {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)},
                 "length": tokens.shape[1]}
    if max_len:
        new_cache = _pad_cache_tree(new_cache, max_len)
    return logits, new_cache


def _pad_cache_tree(cache, max_len):
    """Pad the k/v buffers (dim -3 = seq) up to max_len."""
    s = cache["layers"]["k"].shape[-3]
    if s >= max_len:
        return cache
    pad = (0, 0, 0, 0, 0, max_len - s)  # (D, KVH, S) from the last dim back
    return {
        "layers": {n: F.pad(t, pad) for n, t in cache["layers"].items()},
        "length": cache["length"],
    }
