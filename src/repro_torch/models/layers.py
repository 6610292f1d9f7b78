"""Shared transformer layers: norms, RoPE, attention, MLP, embeddings.

Functions on tensors, ``(params, x, ...) -> y``, with params described
by ParamDef trees, as in the JAX package. Every GEMM goes through
``proj`` and so through the dOS matmul kernel on the card; prefill and
training attention go through the flash kernel. All of them are
differentiable: in training the GEMMs and attention run through the
kernels' autograd Functions. The MoE family's expert FFN is
``models/moe.py``; the cross-attention branch and the gelu MLP wait for
the families that use them (vlm, encdec: ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import decode_attention, dos_matmul, flash_attention
from .params import ParamDef

__all__ = [
    "proj", "rmsnorm", "rmsnorm_def", "rope", "embed_defs", "embed_tokens",
    "unembed", "attn_defs", "attention", "mlp_defs", "mlp",
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


def attention(p, x, cfg, *, mode: str, window: int, theta: float, cache=None):
    """Causal self-attention block. Returns (y, new_cache).

    ``mode`` is ``train`` (whole sequence, no cache: new_cache is None),
    ``prefill`` (whole prompt; the new cache holds its k, v) or
    ``decode`` (one token; ``cache`` is ``{"k", "v", "length"}`` with
    (B, S_max, KVH, D) buffers that this step writes slot ``length`` of
    in place, where the reference returns an updated copy).
    """
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_

    q = proj(x, p["wq"], p.get("bq")).reshape(b, s, h, hd)
    k = proj(x, p["wk"], p.get("bk")).reshape(b, s, kvh, hd)
    v = proj(x, p["wv"], p.get("bv")).reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)

    if mode == "decode":
        if cache is None or s != 1:
            raise ValueError("decode takes one token and a cache")
        length = cache["length"]
        q = rope(q, length, theta)
        k = rope(k, length, theta)
        kc, vc = cache["k"], cache["v"]
        kc[:, length] = k[:, 0].to(kc.dtype)
        vc[:, length] = v[:, 0].to(vc.dtype)
        o = decode_attention(q, kc, vc, length=length + 1, window=window)
        new_cache = {"k": kc, "v": vc, "length": length + 1}
    elif mode in ("prefill", "train"):
        positions = torch.arange(s, device=x.device)
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
        o = flash_attention(q, k, v, causal=True, window=window)
        new_cache = {"k": k, "v": v, "length": s} if mode == "prefill" else None
    else:
        raise ValueError(f"mode {mode!r}: one of train, prefill, decode")

    y = proj(o.reshape(b, s, h * hd), p["wo"])
    return y, new_cache


# --- MLP -----------------------------------------------------------------------


def mlp_defs(cfg):
    if cfg.act != "silu":
        raise NotImplementedError(
            f"act {cfg.act!r}: the gelu MLP waits for its family (ROADMAP queue 1 item 9)"
        )
    e, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": ParamDef((e, f), ("embed", "mlp"), contract=0, out=1),
        "wi_up": ParamDef((e, f), ("embed", "mlp"), contract=0, out=1),
        "wo": ParamDef((f, e), ("mlp", "embed"), contract=0, out=1),
    }


def mlp(p, x):
    """Gated-silu MLP (llama family)."""
    hidden = F.silu(proj(x, p["wi_gate"])) * proj(x, p["wi_up"])
    return proj(hidden, p["wo"])
