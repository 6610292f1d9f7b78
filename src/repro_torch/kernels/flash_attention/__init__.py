from .ops import HEAD_DIMS, VARIANTS, decode_attention, flash_attention, plan
from .ref import NEG_INF, attention_ref

__all__ = ["HEAD_DIMS", "VARIANTS", "flash_attention", "attention_ref", "decode_attention",
           "NEG_INF", "plan"]
