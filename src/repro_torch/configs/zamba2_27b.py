"""Zamba2-2.7B: Mamba2 backbone + shared attention block.

[arXiv:2411.15242; hf]. 54 Mamba2 layers; ONE weight-shared
attention+MLP block applied after every 6th Mamba layer (the paper's
shared block; per-invocation LoRA omitted, as in the JAX package).
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    rope_theta=10_000.0,
    source="arXiv:2411.15242",
)
