"""Llama-4-Scout-17B-16E: MoE with 16 large experts, top-1 routing.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]. Contrast case to
deepseek-moe: expert d_ff=8192 is a LARGE contraction dim, so dOS
sharding of expert FFNs is competitive (paper's large-K regime).
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    n_experts=16,
    n_shared_experts=1,
    top_k=1,
    expert_d_ff=8192,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
