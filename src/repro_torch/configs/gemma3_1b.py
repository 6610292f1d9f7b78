"""Gemma3-1B: 5:1 local:global attention, 1:4 GQA, huge vocab.

[hf:google/gemma-3-1b-pt; unverified]. Local layers use a 1024-token
sliding window with rope theta 10k; every 6th layer is global with
theta 1M. Sub-quadratic (sliding window) -> runs long_500k.
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    head_dim=256,
    rope_theta=10_000.0,
    global_rope_theta=1_000_000.0,
    sliding_window=1024,
    global_every=6,
    qk_norm=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
