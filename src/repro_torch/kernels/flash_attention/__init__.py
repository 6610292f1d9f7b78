from .ops import decode_attention, flash_attention
from .ref import NEG_INF, attention_ref

__all__ = ["flash_attention", "attention_ref", "decode_attention", "NEG_INF"]
