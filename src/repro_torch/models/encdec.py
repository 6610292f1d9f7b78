"""Whisper-style encoder-decoder backbone, the counterpart of the JAX
package's ``models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: the caller gives
precomputed frame embeddings (B, enc_seq, E). The encoder is a
bidirectional transformer over the frames; the decoder is causal
self-attention without rope, cross-attention to the encoder output and
the plain gelu MLP. Positions are sinusoidal, added to the inputs of
both stacks. The layers run in a Python loop over the stacked trees
(``enc_layers`` (L_enc, ...), ``dec_layers`` (L, ...)), as the decoder's
branches do.

The cache is ``{"self": {"k", "v"}, "cross": {"k", "v"}, "length"}``:
the self-attention buffers (L, B, max_len, KVH, D), written in place by
each decode step, and each layer's cross k, v (L, B, enc_seq, KVH, D),
projected once at prefill. One ``length`` for all layers, where the
reference keeps (L,) equal copies.
"""

from __future__ import annotations


import torch
from torch.utils.checkpoint import checkpoint

from ..config import ArchConfig
from .decoder import pad_kv
from .layers import (
    attention, attn_defs, compute_cross_kv, embed_defs, embed_tokens, mlp, mlp_defs, rmsnorm,
    rmsnorm_def, unembed,
)
from .params import map_tree, stack_defs

__all__ = ["encdec_defs", "encode", "encdec_forward", "encdec_init_cache"]


def _sinusoid(seq, dim, offset=0, device=None):
    """(seq, dim) f32 sinusoidal positions from ``offset``: sin over the
    first half of the columns, cos over the second, frequencies
    10000^(-i / max(half - 1, 1)), each step in f32 as the reference's."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None] + offset
    half = dim // 2
    # an f32 value formed on the host (a tensor made on the card would be a
    # copy that waits for it inside a decode step)
    log_base = (torch.log(torch.tensor(10_000.0)) / max(half - 1, 1)).item()
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=device) * log_base)
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block_defs(cfg):
    return {
        "ln1": rmsnorm_def(cfg.d_model),
        "attn": attn_defs(cfg),
        "ln2": rmsnorm_def(cfg.d_model),
        "ffn": mlp_defs(cfg, act="gelu"),
    }


def _dec_block_defs(cfg):
    return {
        "ln1": rmsnorm_def(cfg.d_model),
        "attn": attn_defs(cfg),
        "lnx": rmsnorm_def(cfg.d_model),
        "xattn": attn_defs(cfg),
        "ln2": rmsnorm_def(cfg.d_model),
        "ffn": mlp_defs(cfg, act="gelu"),
    }


def encdec_defs(cfg: ArchConfig):
    return {
        "embed": embed_defs(cfg),
        "enc_layers": stack_defs(_enc_block_defs(cfg), cfg.n_enc_layers),
        "enc_norm": rmsnorm_def(cfg.d_model),
        "dec_layers": stack_defs(_dec_block_defs(cfg), cfg.n_layers),
        "final_norm": rmsnorm_def(cfg.d_model),
    }


def _enc_layer(lp, x, cfg):
    """One encoder layer: bidirectional self-attention (every frame sees
    every other, no rope) and the gelu MLP, each behind its rmsnorm."""
    h, _ = attention(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg, mode="train",
                     causal=False, theta=None)
    x = x + h
    return x + mlp(lp["ffn"], rmsnorm(x, lp["ln2"], cfg.norm_eps))


def encode(params, frames, cfg: ArchConfig):
    """frames (B, enc_seq, E), precomputed stub embeddings -> the encoder
    output (B, enc_seq, E) in the compute dtype."""
    x = frames.to(getattr(torch, cfg.compute_dtype))
    x = x + _sinusoid(x.shape[1], x.shape[2], device=x.device).to(x.dtype)[None]
    stack = map_tree(lambda a: a.unbind(0), params["enc_layers"])  # one unbind a leaf
    for i in range(cfg.n_enc_layers):
        x = _enc_layer(map_tree(lambda a: a[i], stack), x, cfg)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def encdec_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None):
    """A decode-ready cache of zeros (see the module docstring)."""

    def kv(s):
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"self": kv(max_len), "cross": kv(cfg.enc_seq), "length": 0}


def _dec_layer(lp, x, cfg, *, mode, cache, ckv):
    """One decoder layer: causal self-attention (no rope), cross-attention
    to ``ckv``, the gelu MLP, each behind its rmsnorm. Returns (x, the
    self-attention's new cache)."""
    h, new_cache = attention(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg, mode=mode,
                             cache=cache, theta=None)
    x = x + h
    hx, _ = attention(lp["xattn"], rmsnorm(x, lp["lnx"], cfg.norm_eps), cfg, mode=mode,
                      cross_kv=ckv)
    x = x + hx
    return x + mlp(lp["ffn"], rmsnorm(x, lp["ln2"], cfg.norm_eps)), new_cache


def encdec_forward(params, tokens, cfg: ArchConfig, *, mode: str, enc_frames=None, cache=None,
                   max_len: int = 0, remat=False):
    """tokens (B, S) decoder tokens -> (logits (B, S, V) f32, new cache).
    Train and prefill encode ``enc_frames`` (B, enc_seq, E); decode reads
    the cross k, v from the cache. ``remat`` (train only) recomputes each
    decoder layer in the backward; the encoder is not recomputed, as in
    the reference."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: one of train, prefill, decode")
    x = embed_tokens(params["embed"], tokens, getattr(torch, cfg.compute_dtype))
    _, s, e = x.shape
    if mode == "decode":
        offset, enc_out = cache["length"], None
    else:
        if enc_frames is None:
            raise ValueError(f"{cfg.name}: {mode} needs enc_frames (B, {cfg.enc_seq}, {e})")
        offset, enc_out = 0, encode(params, enc_frames, cfg)
    x = x + _sinusoid(s, e, offset=offset, device=x.device).to(x.dtype)[None]

    def train_layer(lp, x, enc_out):
        ckv = compute_cross_kv(lp["xattn"], enc_out, cfg)
        return _dec_layer(lp, x, cfg, mode="train", cache=None, ckv=ckv)[0]

    stack = map_tree(lambda a: a.unbind(0), params["dec_layers"])  # one unbind a leaf
    ks, vs, cross_k, cross_v = [], [], [], []  # prefill: each layer's new k, v
    for i in range(cfg.n_layers):
        lp = map_tree(lambda a: a[i], stack)
        if mode == "decode":
            sc = {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i],
                  "length": cache["length"]}
            x, _ = _dec_layer(lp, x, cfg, mode=mode, cache=sc,
                              ckv=(cache["cross"]["k"][i], cache["cross"]["v"][i]))
            continue
        if mode == "train":
            x = (checkpoint(train_layer, lp, x, enc_out, use_reentrant=False) if remat
                 else train_layer(lp, x, enc_out))
            continue
        ckv = compute_cross_kv(lp["xattn"], enc_out, cfg)
        x, nc = _dec_layer(lp, x, cfg, mode=mode, cache=None, ckv=ckv)
        ks.append(nc["k"])
        vs.append(nc["v"])
        cross_k.append(ckv[0])
        cross_v.append(ckv[1])

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    if mode == "train":
        return logits, None
    if mode == "decode":
        return logits, {"self": cache["self"], "cross": cache["cross"],
                        "length": cache["length"] + 1}
    self_kv = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return logits, {"self": pad_kv(self_kv, max_len) if max_len else self_kv,
                    "cross": {"k": torch.stack(cross_k), "v": torch.stack(cross_v)},
                    "length": s}
