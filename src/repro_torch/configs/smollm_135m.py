"""SmolLM-135M: llama-architecture small model. [hf:HuggingFaceTB/SmolLM-135M; hf]"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    head_dim=64,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
