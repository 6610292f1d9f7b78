"""Llama-3.2-Vision-11B text backbone + cross-attn image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]. 40 layers total:
every 5th layer cross-attends to (stub) precomputed image patch
embeddings; the other 32 are standard GQA self-attention layers.
The vision tower is a stub per the assignment (input_specs supplies
patch embeddings).
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_every=5,
    n_image_tokens=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    notes="vision frontend stubbed: precomputed patch embeds",
)
