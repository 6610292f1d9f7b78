"""Whisper-medium: encoder-decoder with stubbed conv frontend.

[arXiv:2212.04356; unverified]. 24 encoder + 24 decoder layers,
MHA (kv == q heads). input_specs supplies precomputed frame
embeddings (B, 1500, 1024); decode shapes exercise decoder self-cache
+ cross-attention; long_500k skipped (full attention).
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_enc_layers=24,
    enc_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    head_dim=64,
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2212.04356",
    notes="conv/mel frontend stubbed per assignment",
)
