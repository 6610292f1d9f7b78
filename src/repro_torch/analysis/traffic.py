"""Kernel-aware analytic HBM traffic model (per device, per step).

A numpy copy of the JAX package's ``analysis/traffic.py``: the serving
simulator (``core.serve``) prices each step's KV-cache and weight
traffic with it, so it stays the reference's model, TPU target included.

The dry-run's HLO ``bytes accessed`` is exact for the *CPU fallback*
graph — but the fallback materializes flash/SSD probability blocks that
the Pallas kernels keep in VMEM on the TPU target. This module computes
the TPU-kernel-true HBM traffic from the model structure; the roofline
reports both (HLO per spec, kernel-adjusted for optimization decisions).

Accounting (2-byte activations/weights unless stated):

weights  train: mb grad-accum passes read the device's weight shard
         twice (fwd+bwd) in bf16; gradients accumulate in f32 (r+w per
         microbatch); AdamW reads/writes p, m, v in f32 once per step.
         serve: one bf16 read of the weight shard per step.
activations  per layer per local token: residual stream r/w + block
         in/out traffic (q/k/v/o, MLP hidden r+w, SSD inner), x3 for
         backward (recompute read + grad traffic) under remat.
attention kernel: reads q, k, v once, writes o (no S^2 traffic);
         backward ~2x forward reads + dq/dk/dv writes.
kv cache decode: full cache shard read per step + one slot written.
logits:  bf16 write + f32 softmax r/w on the vocab shard.
"""

from __future__ import annotations

from ..config import ArchConfig, ShapeConfig
from ..core.ppa import constants as HW

__all__ = [
    "attn_ssm_layer_split",
    "hbm_seconds_per_device",
    "kv_bytes_per_context_token",
    "state_bytes_per_request",
    "traffic_bytes_per_device",
]

_B2, _B4 = 2, 4


def attn_ssm_layer_split(cfg: ArchConfig) -> tuple[int, int]:
    """(n_attention_layers, n_ssm_layers) of one forward pass.

    Hybrids (zamba2) run an SSM backbone of ``n_layers`` blocks PLUS a
    weight-shared attention+MLP block applied every ``attn_every``
    layers (``core.network._lower_hybrid``); pure-attention families
    have ``n_attn = n_layers``, pure SSM ``n_ssm = n_layers``. The one
    split every per-layer accounting in this module (and the serving
    simulator's kv-cache pricing) agrees on.
    """
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        return n_attn, cfg.n_layers
    if cfg.family == "ssm":
        return 0, cfg.n_layers
    return cfg.n_layers, 0


def kv_bytes_per_context_token(cfg: ArchConfig, bytes_kv: int = _B2) -> float:
    """kv-cache footprint [bytes] of ONE context token across all
    attention layers (K + V, ``n_kv_heads x head_dim`` each).

    A decode step reads ``context_len *`` this per request (the full
    cache shard read of ``traffic_bytes_per_device``) and writes one
    new slot; the serving simulator (``core.serve``) prices both
    against the DRAM interface.
    """
    n_attn, _ = attn_ssm_layer_split(cfg)
    return float(n_attn * 2 * cfg.n_kv_heads * cfg.head_dim_ * bytes_kv)


def state_bytes_per_request(cfg: ArchConfig) -> float:
    """SSM recurrent-state traffic [bytes] of one decode step for one
    request: the f32 state read + written once per SSM layer (the
    context-length-independent analogue of the kv cache)."""
    _, n_ssm = attn_ssm_layer_split(cfg)
    if not n_ssm:
        return 0.0
    di = cfg.ssm_expand * cfg.d_model
    nst = (di // cfg.ssm_head_dim) * cfg.ssm_state * cfg.ssm_head_dim
    return float(n_ssm * nst * _B4 * 2)


def hbm_seconds_per_device(
    cfg: ArchConfig,
    shape: ShapeConfig,
    n_params: int,
    *,
    hbm_bw: float = HW.TPU_HBM_BW,
    **kw,
) -> float:
    """Kernel-true HBM service time [s] of one step on one device.

    ``traffic_bytes_per_device(...) / hbm_bw`` — the memory term the
    roofline combiner (``analysis.roofline.roofline_terms_batched``)
    consumes as ``memory_s_kernel``; ``hbm_bw`` is bytes/s (default:
    the v5e HBM model). Keyword args pass through to
    ``traffic_bytes_per_device``.
    """
    return traffic_bytes_per_device(cfg, shape, n_params, **kw) / hbm_bw


def traffic_bytes_per_device(
    cfg: ArchConfig,
    shape: ShapeConfig,
    n_params: int,
    *,
    n_chips: int,
    model_ax: int = 16,
    microbatches: int = 1,
) -> float:
    mode = shape.mode
    tokens_local = shape.global_batch * shape.seq_len / max(n_chips / model_ax, 1)
    if mode == "decode":
        tokens_local = shape.global_batch / max(n_chips / model_ax, 1)
        tokens_local = max(tokens_local, 1.0)

    e = cfg.d_model
    hd = cfg.head_dim_
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    f = cfg.expert_d_ff * (cfg.top_k + cfg.n_shared_experts) if cfg.family == "moe" else cfg.d_ff

    # --- weights + optimizer ---------------------------------------------
    w_shard = n_params / model_ax  # elements read per device per pass
    w_all_shard = n_params / n_chips  # FSDP storage shard (opt state)
    if mode == "train":
        w_traffic = microbatches * 2 * w_shard * _B2  # fwd + bwd bf16 reads
        w_traffic += microbatches * 2 * w_all_shard * _B4  # grad accum r+w f32
        w_traffic += 6 * w_all_shard * _B4  # adam p,m,v read+write
    else:
        w_traffic = w_shard * _B2

    # --- per-layer activation traffic (per local token) ---------------------
    # residual r/w (~6E), qkv out, attn o in/out, mlp hidden r+w (~3F incl
    # gate/up write + read), norms (~2E). Heads dims sharded over model.
    # Mixed-family layer split (see attn_ssm_layer_split) — attention
    # accounting scales with n_attn_layers, SSM accounting with
    # n_ssm_layers, so neither component is double- or zero-counted.
    n_attn_layers, n_ssm_layers = attn_ssm_layer_split(cfg)
    attn_io = (h * hd + 2 * kvh * hd + 2 * h * hd) / model_ax
    attn_blk = 8 * e / model_ax + attn_io + 3 * f / model_ax
    di = cfg.ssm_expand * e
    ssm_blk = 8 * e + (4 * di + 2 * cfg.ssm_state) / model_ax + 2 * di / model_ax
    fwd_act = (
        tokens_local
        * (n_attn_layers * attn_blk + n_ssm_layers * ssm_blk)
        * _B2
    )
    act_traffic = fwd_act * (3.0 if mode == "train" else 1.0)

    # --- attention kernel HBM traffic ----------------------------------------
    if n_attn_layers:
        qkv = tokens_local * (h + 2 * kvh) * hd / model_ax
        o = tokens_local * h * hd / model_ax
        per_layer = (qkv + o) * _B2
        if mode == "train":
            per_layer *= 3.0  # bwd rereads qkv/o/do + writes dq/dk/dv
        act_traffic += n_attn_layers * per_layer

    # --- kv cache / state (decode) ---------------------------------------------
    if mode == "decode":
        if n_attn_layers:
            # read the full local cache shard once
            act_traffic += (
                shape.global_batch * shape.seq_len
                * kv_bytes_per_context_token(cfg) / n_chips
            )
        if n_ssm_layers:
            act_traffic += (
                shape.global_batch * state_bytes_per_request(cfg) / n_chips
            )

    # --- logits ----------------------------------------------------------------
    v_shard = cfg.vocab / model_ax
    logit_traffic = tokens_local * v_shard * (_B2 + 2 * _B4)
    if mode == "train":
        logit_traffic *= 2.0

    return float(w_traffic + act_traffic + logit_traffic)
