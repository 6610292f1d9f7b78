"""Configuration system: architectures and input shapes.

A copy of the JAX package's ``config.py`` (minus ``RunConfig``, which
belongs to the multi-device launcher that is not ported yet), kept
separate so that the port imports nothing of ``repro``. Every field and
default is the same, so a config built here describes the same model.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "reduced"]

Mode = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"
    # --- attention pattern ---------------------------------------------
    sliding_window: int = 0  # 0 = all layers global
    global_every: int = 0  # every Nth layer global (gemma3: 6 -> 5:1)
    global_rope_theta: float = 0.0  # 0 -> rope_theta
    qk_norm: bool = False
    # --- MoE -------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    # --- SSM / hybrid -----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0  # zamba2: shared attention after every Nth block
    slstm_at: tuple = ()  # xlstm: block indices running sLSTM
    # --- encoder-decoder --------------------------------------------------
    n_enc_layers: int = 0
    enc_seq: int = 0  # stub-frontend sequence length (whisper frames)
    # --- VLM ---------------------------------------------------------------
    cross_every: int = 0  # every Nth decoder layer is vision cross-attn
    n_image_tokens: int = 0
    # --- numerics / compilation -------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True
    # unroll inner chunk-scans (flash/SSD) so cost_analysis counts every
    # trip — used by the dry-run's small unrolled cost variants only.
    unroll_inner: bool = False
    # --- provenance ---------------------------------------------------------
    source: str = ""
    notes: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch run long_500k? SSM/hybrid/sliding-window only."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d, v = self.d_model, self.vocab
        hd = self.head_dim_
        emb = v * d * (1 if self.tie_embeddings else 2)
        att = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "moe":
            ff_r = 3 * d * self.expert_d_ff * self.n_experts
            ff_s = 3 * d * self.expert_d_ff * self.n_shared_experts
            ff = ff_r + ff_s + d * self.n_experts  # + router
        elif self.family in ("ssm",):
            ff = 0
        else:
            ff = 3 * d * self.d_ff
        if self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            ssm = d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim) + d_in * d
            per_layer = ssm if self.family == "ssm" else ssm  # hybrids: + shared attn once
        else:
            per_layer = att + ff
        if self.family == "hybrid":
            total = self.n_layers * per_layer + (att + 3 * d * self.d_ff)
        elif self.family == "ssm":
            # xlstm: qkv projections + gates per block
            total = self.n_layers * (4 * d * d + 2 * d)
        else:
            total = self.n_layers * per_layer
        if self.family == "encdec":
            total += self.n_enc_layers * (att + 3 * d * self.d_ff)
        return total + emb

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE-aware), for MODEL_FLOPS."""
        if self.family != "moe":
            return self.n_params
        d = self.d_model
        ff_active = 3 * d * self.expert_d_ff * (self.top_k + self.n_shared_experts)
        hd = self.head_dim_
        att = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (att + ff_active) + emb


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: Mode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ArchConfig, seq: int = 128) -> ArchConfig:
    """A smoke-test-sized config of the same family: small dims, few
    layers, tiny vocab — but the same block structure and patterns."""
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(4, max(1, cfg.n_kv_heads * 4 // max(cfg.n_heads, 1))),
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=256,
        scan_layers=cfg.scan_layers,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.global_every:
        kw["global_every"] = 2
        kw["sliding_window"] = min(cfg.sliding_window, seq // 2) or 64
    elif cfg.sliding_window:
        kw["sliding_window"] = min(cfg.sliding_window, 64)
    if cfg.family == "moe":
        kw.update(n_experts=8, n_shared_experts=min(cfg.n_shared_experts, 1),
                  top_k=min(cfg.top_k, 2), expert_d_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16)
    if cfg.attn_every:
        kw["attn_every"] = 2
    if cfg.slstm_at:
        kw["slstm_at"] = (1,)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, enc_seq=64)
    if cfg.family == "vlm":
        kw.update(cross_every=2, n_image_tokens=16)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
