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

On a mesh (a ``layers.Layout``) both stacks run on this rank's rows and
shards as the decoder's dense branch does: under ``dos`` the frames,
the residuals and the sinusoid added to them are split on E; the
encoder's non-causal attention, the decoder's self- and cross-attention
run on the rank's heads; each layer's FSDP shards are gathered just
before it runs; the prefill's cache is placed as ``self`` and ``cross``
are in the reference's table (``decoder.placed_cache``). Whisper's
51,865-row vocab divides neither 2 nor 4, so its tied embedding stays
whole on every rank.
"""

from __future__ import annotations


import torch
from torch.utils.checkpoint import checkpoint

from ..config import ArchConfig
from ..parallel import collectives as C
from .decoder import pad_kv, placed_cache, ring_of
from .layers import (
    ONE, Layout, attention, attn_defs, compute_cross_kv, embed_defs, embed_tokens, mlp, mlp_defs,
    rmsnorm, rmsnorm_def, unembed,
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


def _positions(seq, cfg, lay: Layout, offset=0, device=None):
    """The sinusoid (seq, E) from ``offset``, split on E as the residual is."""
    pos = _sinusoid(seq, cfg.d_model, offset=offset, device=device)
    return C.local_slice(pos, lay.mesh, lay.tp, -1) if lay.resid else pos


def _enc_layer(lp, x, cfg, lay: Layout = ONE):
    """One encoder layer: bidirectional self-attention (every frame sees
    every other, no rope) and the gelu MLP, each behind its rmsnorm."""
    lp = lay.gather(lp, "enc_layers")
    h, _ = attention(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps, lay, lay.resid), cfg,
                     mode="train", causal=False, theta=None, lay=lay)
    x = x + h
    return x + mlp(lp["ffn"], rmsnorm(x, lp["ln2"], cfg.norm_eps, lay, lay.resid), lay)


def encode(params, frames, cfg: ArchConfig, lay: Layout = ONE):
    """frames (B, enc_seq, E), precomputed stub embeddings -> the encoder
    output (B, enc_seq, E) in the compute dtype (on a mesh: this rank's
    rows, split on E if ``lay.resid``, in and out)."""
    x = frames.to(getattr(torch, cfg.compute_dtype))
    x = x + _positions(x.shape[1], cfg, lay, device=x.device).to(x.dtype)[None]
    stack = map_tree(lambda a: a.unbind(0), params["enc_layers"])  # one unbind a leaf
    for i in range(cfg.n_enc_layers):
        x = _enc_layer(map_tree(lambda a: a[i], stack), x, cfg, lay)
    return rmsnorm(x, lay.gather(params["enc_norm"], "enc_norm"), cfg.norm_eps, lay, lay.resid)


def encdec_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None):
    """A decode-ready cache of zeros (see the module docstring)."""

    def kv(s):
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"self": kv(max_len), "cross": kv(cfg.enc_seq), "length": 0}


def _dec_layer(lp, x, cfg, *, mode, cache, ckv, lay: Layout = ONE, cross_ring=None):
    """One decoder layer (``lp`` gathered): causal self-attention (no
    rope), cross-attention to ``ckv``, the gelu MLP, each behind its
    rmsnorm. Returns (x, the self-attention's new cache)."""

    def norm(x, name):
        return rmsnorm(x, lp[name], cfg.norm_eps, lay, lay.resid)

    h, new_cache = attention(lp["attn"], norm(x, "ln1"), cfg, mode=mode, cache=cache, theta=None,
                             lay=lay)
    x = x + h
    hx, _ = attention(lp["xattn"], norm(x, "lnx"), cfg, mode=mode, cache=cross_ring,
                      cross_kv=ckv, lay=lay, group="xattn")
    x = x + hx
    return x + mlp(lp["ffn"], norm(x, "ln2"), lay), new_cache


def encdec_forward(params, tokens, cfg: ArchConfig, *, mode: str, enc_frames=None, cache=None,
                   max_len: int = 0, remat=False, lay: Layout = ONE):
    """tokens (B, S) decoder tokens -> (logits (B, S, V) f32, new cache).
    Train and prefill encode ``enc_frames`` (B, enc_seq, E); decode reads
    the cross k, v from the cache. ``remat`` (train only) recomputes each
    decoder layer in the backward; the encoder is not recomputed, as in
    the reference. On a mesh (``lay``) the tokens and frames are this
    rank's rows (the frames split on E if ``lay.resid``)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: one of train, prefill, decode")
    emb = lay.gather(params["embed"], "embed")
    x = embed_tokens(emb, tokens, getattr(torch, cfg.compute_dtype), lay)
    s = x.shape[1]
    if mode == "decode":
        offset, enc_out = cache["length"], None
    else:
        if enc_frames is None:
            raise ValueError(f"{cfg.name}: {mode} needs enc_frames (B, {cfg.enc_seq}, "
                             f"{cfg.d_model})")
        offset, enc_out = 0, encode(params, enc_frames, cfg, lay)
    x = x + _positions(s, cfg, lay, offset=offset, device=x.device).to(x.dtype)[None]

    def train_layer(lp, x, enc_out):
        lp = lay.gather(lp, "dec_layers")
        ckv = compute_cross_kv(lp["xattn"], enc_out, cfg, lay, "xattn")
        return _dec_layer(lp, x, cfg, mode="train", cache=None, ckv=ckv, lay=lay)[0]

    stack = map_tree(lambda a: a.unbind(0), params["dec_layers"])  # one unbind a leaf
    ring = ring_of(lay, cfg, cache, "self") if mode == "decode" else {}
    cross_ring = ring_of(lay, cfg, cache, "cross") if mode == "decode" else {}
    ks, vs, cross_k, cross_v = [], [], [], []  # prefill: each layer's new k, v
    for i in range(cfg.n_layers):
        lp = map_tree(lambda a: a[i], stack)
        if mode == "decode":
            sc = {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i],
                  "length": cache["length"], **ring}
            x, _ = _dec_layer(lay.gather(lp, "dec_layers"), x, cfg, mode=mode, cache=sc,
                              ckv=(cache["cross"]["k"][i], cache["cross"]["v"][i]), lay=lay,
                              cross_ring=cross_ring or None)
            continue
        if mode == "train":
            x = (checkpoint(train_layer, lp, x, enc_out, use_reentrant=False) if remat
                 else train_layer(lp, x, enc_out))
            continue
        lp = lay.gather(lp, "dec_layers")
        ckv = compute_cross_kv(lp["xattn"], enc_out, cfg, lay, "xattn")
        x, nc = _dec_layer(lp, x, cfg, mode=mode, cache=None, ckv=ckv, lay=lay)
        ks.append(nc["k"])
        vs.append(nc["v"])
        cross_k.append(ckv[0])
        cross_v.append(ckv[1])

    x = rmsnorm(x, lay.gather(params["final_norm"], "final_norm"), cfg.norm_eps, lay, lay.resid)
    logits = unembed(emb, x, cfg.tie_embeddings, lay)
    if mode == "train":
        return logits, None
    if mode == "decode":  # a mesh's cache keeps its placement's keys
        return logits, {**cache, "length": cache["length"] + 1}
    self_kv = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return logits, placed_cache(lay, cfg, {
        "self": pad_kv(self_kv, max_len) if max_len else self_kv,
        "cross": {"k": torch.stack(cross_k), "v": torch.stack(cross_v)}, "length": s})
