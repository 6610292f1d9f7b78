"""DeepSeekMoE-16B: fine-grained experts, 2 shared + 64 routed top-6.

[arXiv:2401.06066; hf]. All layers MoE (the real model's first dense
layer is simplified to MoE; see DESIGN.md). Fine-grained expert
d_ff=1408 gives a SMALL GEMM contraction dim per expert — the paper's
small-K regime where dOS loses (Fig. 5), which the advisor reproduces.
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    expert_d_ff=1408,
    rope_theta=10_000.0,
    source="arXiv:2401.06066",
)
