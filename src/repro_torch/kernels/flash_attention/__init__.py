from .ops import HEAD_DIMS, VARIANTS, decode_attention, flash_attention, flash_attention_bwd, plan
from .ref import NEG_INF, attention_bwd_ref, attention_fwd_ref, attention_ref, decode_attention_ref

__all__ = ["HEAD_DIMS", "VARIANTS", "flash_attention", "flash_attention_bwd",
           "attention_ref", "attention_fwd_ref", "attention_bwd_ref", "decode_attention",
           "decode_attention_ref",
           "NEG_INF", "plan"]
