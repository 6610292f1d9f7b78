"""Qwen2.5-3B: GQA with QKV bias. [hf:Qwen/Qwen2.5-3B (dims per assignment); hf]"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-3B",
)
