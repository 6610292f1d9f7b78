"""Shared transformer layers: norms, RoPE, attention, MLP, embeddings.

Functions on tensors, ``(params, x, ...) -> y``, with params described
by ParamDef trees, as in the JAX package. Every GEMM goes through
``proj`` and so through the dOS matmul kernel on the card; prefill and
training attention go through the flash kernel. All of them are
differentiable: in training the GEMMs and attention run through the
kernels' autograd Functions. ``attention`` is the reference's universal
block: causal self-attention with or without rope (whisper's decoder
passes ``theta=None``), bidirectional (``causal=False``, whisper's
encoder) and cross-attention to keys and values that
``compute_cross_kv`` projects once from an outside source (the vision
model's image embeddings, whisper's encoder output). ``mlp`` is the
gated-silu MLP or the plain 2-layer gelu one (whisper), as its tree's
keys say. The MoE family's expert FFN is ``models/moe.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import decode_attention, dos_matmul, flash_attention
from .params import ParamDef

__all__ = [
    "proj", "rmsnorm", "rmsnorm_def", "rope", "embed_defs", "embed_tokens",
    "unembed", "attn_defs", "compute_cross_kv", "attention", "mlp_defs", "mlp",
]


def proj(x, w, b=None):
    """x (..., K) @ w (K, N) in compute dtype, f32 accumulation.

    The weight is cast to the compute dtype here, as the reference's
    ``astype`` does on every call: in training ``w`` is the f32 master
    and its gradient passes back through the cast. Serving casts once at
    load (``Model.compute_params``), which gives the same values and
    saves a read, a write and a cast per call; for a weight already in
    x's dtype ``.to`` returns it unchanged."""
    y = dos_matmul(x, w.to(x.dtype), out_dtype=x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


# --- norms ---------------------------------------------------------------


def rmsnorm_def(dim: int, axes=("embed",)):
    return ParamDef((dim,), axes, init="ones")


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# --- rotary embeddings -----------------------------------------------------


def rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (S,) tensor or an int (decode)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -torch.log(torch.full((), theta, dtype=torch.float32, device=x.device))
        * (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    )
    if isinstance(positions, int):
        ang = (freqs * float(positions))[None, :]  # (1, half)
    else:
        ang = positions.float()[:, None] * freqs  # (S, half)
    cos = torch.cos(ang)[:, None, :]  # (S, 1, half)
    sin = torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- embeddings -------------------------------------------------------------


def embed_defs(cfg):
    defs = {"tok": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02)}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef(
            (cfg.d_model, cfg.vocab), ("embed", "vocab"), contract=0, out=1
        )
    return defs


def embed_tokens(p, tokens, compute_dtype):
    # the backward of F.embedding (torch's embedding backward) gave the same
    # bits in two runs on the card: chip_smoke.py phase 12's restart check
    # holds the resumed losses to an uninterrupted run's bit for bit
    return F.embedding(tokens, p["tok"]).to(compute_dtype)


def unembed(p, x, tie: bool):
    """Logits in f32. The tied head is the transposed embedding, passed
    to the matmul kernel as a strided view (no copy)."""
    w = p["tok"].T if tie else p["head"]
    return proj(x, w).float()


# --- attention ---------------------------------------------------------------


def attn_defs(cfg):
    e, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    defs = {
        "wq": ParamDef((e, h * hd), ("embed", "heads_flat"), contract=0, out=1),
        "wk": ParamDef((e, kvh * hd), ("embed", "heads_flat"), contract=0, out=1),
        "wv": ParamDef((e, kvh * hd), ("embed", "heads_flat"), contract=0, out=1),
        "wo": ParamDef((h * hd, e), ("heads_flat", "embed"), contract=0, out=1),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h * hd,), ("heads_flat",), init="zeros")
        defs["bk"] = ParamDef((kvh * hd,), ("heads_flat",), init="zeros")
        defs["bv"] = ParamDef((kvh * hd,), ("heads_flat",), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = rmsnorm_def(hd, ("head_dim",))
        defs["k_norm"] = rmsnorm_def(hd, ("head_dim",))
    return defs


def compute_cross_kv(p, kv_src, cfg):
    """Project a cross-attention source (image embeddings, encoder
    output) (B, Skv, E) to ``(k, v)``, each (B, Skv, KVH, D): once at
    prefill, read from the cache by every decode step. ``proj`` casts the
    weights to the source's dtype, as the reference's does."""
    b, skv, _ = kv_src.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim_
    k = proj(kv_src, p["wk"], p.get("bk")).reshape(b, skv, kvh, hd)
    v = proj(kv_src, p["wv"], p.get("bv")).reshape(b, skv, kvh, hd)
    return k, v


def attention(p, x, cfg, *, mode: str, window=None, theta=None, cache=None, cross_kv=None,
              causal: bool = True):
    """The universal attention block. Returns (y, new_cache).

    ``mode`` is ``train`` (whole sequence, no cache: new_cache is None),
    ``prefill`` (whole prompt; the new cache holds its k, v) or
    ``decode`` (one token; ``cache`` is ``{"k", "v", "length"}`` with
    (B, S_max, KVH, D) buffers that this step writes slot ``length`` of
    in place, where the reference returns an updated copy). ``theta``
    None applies no rope. With ``cross_kv`` (k, v) the block attends to
    them, every key visible (no mask, no window, no rope); q is normed if
    ``cfg.qk_norm``, k is not, as in the reference; a cross block returns
    no cache.
    """
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: one of train, prefill, decode")

    q = proj(x, p["wq"], p.get("bq")).reshape(b, s, h, hd)
    if cross_kv is None:
        k = proj(x, p["wk"], p.get("bk")).reshape(b, s, kvh, hd)
        v = proj(x, p["wv"], p.get("bv")).reshape(b, s, kvh, hd)
    else:
        k, v = cross_kv
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        if cross_kv is None:
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)

    new_cache = None
    if cross_kv is not None:
        if mode == "decode":
            o = decode_attention(q, k, v, length=k.shape[1], window=None)
        else:
            o = flash_attention(q, k, v, causal=False, window=None)
    elif mode == "decode":
        if cache is None or s != 1:
            raise ValueError("decode takes one token and a cache")
        length = cache["length"]
        if theta is not None:
            q = rope(q, length, theta)
            k = rope(k, length, theta)
        kc, vc = cache["k"], cache["v"]
        kc[:, length] = k[:, 0].to(kc.dtype)
        vc[:, length] = v[:, 0].to(vc.dtype)
        o = decode_attention(q, kc, vc, length=length + 1, window=window)
        new_cache = {"k": kc, "v": vc, "length": length + 1}
    else:
        if theta is not None:
            positions = torch.arange(s, device=x.device)
            q = rope(q, positions, theta)
            k = rope(k, positions, theta)
        o = flash_attention(q, k, v, causal=causal, window=window)
        if mode == "prefill":
            new_cache = {"k": k, "v": v, "length": s}

    y = proj(o.reshape(b, s, h * hd), p["wo"])
    return y, new_cache


# --- MLP -----------------------------------------------------------------------


def mlp_defs(cfg, d_ff=None, act=None):
    e = cfg.d_model
    f = d_ff or cfg.d_ff
    act = act or cfg.act
    if act == "silu":  # gated (llama family)
        return {
            "wi_gate": ParamDef((e, f), ("embed", "mlp"), contract=0, out=1),
            "wi_up": ParamDef((e, f), ("embed", "mlp"), contract=0, out=1),
            "wo": ParamDef((f, e), ("mlp", "embed"), contract=0, out=1),
        }
    return {  # plain 2-layer (whisper)
        "wi": ParamDef((e, f), ("embed", "mlp"), contract=0, out=1),
        "bi": ParamDef((f,), ("mlp",), init="zeros"),
        "wo": ParamDef((f, e), ("mlp", "embed"), contract=0, out=1),
        "bo": ParamDef((e,), ("embed",), init="zeros"),
    }


def mlp(p, x):
    """The gated-silu MLP (llama family) if the tree has ``wi_gate``, else
    the plain 2-layer MLP with the tanh form of gelu (``jax.nn.gelu``'s
    default). The tree's keys pick the form, as in the reference, whose
    ``act`` argument picks nothing."""
    if "wi_gate" in p:
        hidden = F.silu(proj(x, p["wi_gate"])) * proj(x, p["wi_up"])
        return proj(hidden, p["wo"])
    hidden = F.gelu(proj(x, p["wi"], p["bi"]), approximate="tanh")
    return proj(hidden, p["wo"], p["bo"])
