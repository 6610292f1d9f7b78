from .ops import VARIANTS, Plan, dos_matmul, plan
from .ref import dos_matmul_ref, matmul_ref

__all__ = ["VARIANTS", "Plan", "dos_matmul", "dos_matmul_ref", "matmul_ref", "plan"]
