from .ops import VARIANTS, adamw, norm_work, sum_squares, work
from .ref import adamw_ref, sum_squares_ref

__all__ = ["VARIANTS", "adamw", "adamw_ref", "norm_work", "sum_squares", "sum_squares_ref",
           "work"]
