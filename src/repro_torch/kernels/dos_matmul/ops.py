"""Public op: the dOS matmul, dispatched by the device of its operands.

For CPU tensors the op runs its plain version (``matmul_ref``). For CUDA
tensors it launches the hand-written kernel of ``csrc/dos_matmul.cu``
(built on first use), or raises: nothing falls back. The reference's
padding to block multiples, its ``MIN_TILE_*`` dispatch of small shapes
to the plain GEMM and its VMEM-sized ``pick_blocks`` are TPU facts and
have no counterpart: the kernel masks ragged edges itself, so every
shape, the decode step's M = 4 included, goes through it.

``dos_matmul.launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import matmul_ref

__all__ = ["dos_matmul"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("dos_matmul")
        lib.dos_matmul_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 5
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.dos_matmul_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def dos_matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """``a(..., M, K) @ b(K, N)`` with f32 accumulation.

    Leading dims of ``a`` are flattened into M. ``b`` may be a row-major
    matrix or a transposed view (the tied unembedding passes the
    embedding table's ``.T``).
    """
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"dos_matmul: operands on {a.device} and {b.device}")
    if b.dim() != 2 or a.shape[-1] != b.shape[0]:
        raise ValueError(f"dos_matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if 1 not in b.stride():
        raise ValueError(f"dos_matmul kernel needs a unit stride in B; got {b.stride()}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(
            f"dos_matmul kernel takes f32 or bf16 operands of one dtype and an "
            f"f32 or bf16 output; got {a.dtype}, {b.dtype} -> {out_dtype}"
        )
    lead = a.shape[:-1]
    k, n = b.shape
    a2 = a.reshape(-1, k).contiguous()
    m = a2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m and n:
        lib = _lib()
        err = lib.dos_matmul_launch(
            a2.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            b.stride(0), b.stride(1), _DTYPES[a.dtype], _DTYPES[out_dtype],
            torch.cuda.current_stream(a.device).cuda_stream,
        )
        _build.check(lib, err, "dos_matmul")
        dos_matmul.launches += 1
    return out.reshape(*lead, n)


dos_matmul.launches = 0
