from .ops import dos_matmul
from .ref import dos_matmul_ref, matmul_ref

__all__ = ["dos_matmul", "dos_matmul_ref", "matmul_ref"]
