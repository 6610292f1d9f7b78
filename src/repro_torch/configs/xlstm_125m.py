"""xLSTM-125M: mLSTM + sLSTM blocks. [arXiv:2405.04517; unverified]

12 blocks, d_model 768; sLSTM at blocks {3, 9}, mLSTM elsewhere
(d_ff=0: the xLSTM block IS the mixer, no separate MLP). The paper's
dOS applies to the q/k/v/out projections only — the recurrence itself
is outer-product (K=1); see DESIGN.md §Arch-applicability. SSM family
-> runs long_500k.
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=192,
    ssm_state=96,      # mLSTM q/k dim per head
    ssm_head_dim=192,  # mLSTM value dim per head
    slstm_at=(3, 9),
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
