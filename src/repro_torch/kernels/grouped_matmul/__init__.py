from .ops import VARIANTS, grouped_matmul, grouped_matmul_dw, plan, tile_map
from .ref import grouped_matmul_dw_ref, grouped_matmul_ref

__all__ = ["VARIANTS", "grouped_matmul", "grouped_matmul_dw", "grouped_matmul_dw_ref",
           "grouped_matmul_ref", "plan", "tile_map"]
