"""Public ops: the grouped GEMM of the MoE experts and its weight
gradient, dispatched by the device of their operands.

``grouped_matmul(x, w, group_sizes)`` is the reference's
``jax.lax.ragged_dot``: x (R, K) with its rows sorted by group, w (G, K,
N), group_sizes (G,) int32; rows of group g multiply w[g], rows past the
sum of the sizes are zero; f32 sums, output in x's type.
``grouped_matmul_dw(x, dy, group_sizes)`` is its weight gradient, (G, K,
N) in f32.

For CPU tensors each op runs its plain version (``ref.py``). For CUDA
tensors it launches a hand-written kernel of ``csrc/grouped_matmul.cu``
(built on first use), or raises: nothing falls back. The sizes stay on
the device: the kernel forms the offsets, so a call never waits for the
host. ``plan`` picks the variant before the launch:

- ``mma``: bf16 with 16-byte rows (x with a unit inner stride and a row
  stride a multiple of 8; w with a unit stride along n, or along k as in
  ``w.transpose(-1, -2)``, its other strides multiples of 8; 16-byte
  aligned bases): bf16 tensor cores (``mma.sync``). A block takes BM rows
  of one group: 32 where the groups hold a few rows each (decode), 64 or
  128 as they grow, from R / G, which the host knows.
- ``fma``: f32 operands, and bf16 ones off those rows: f32 FMAs, any
  strides.

``grouped_matmul_dw`` takes ``mma`` for bf16 x and dy with 16-byte rows,
``fma`` otherwise; the private ``_launch_dw(..., force_fma=True)``
launches ``fma`` whatever the plan says, to check and time both
variants on the same inputs. ``.launches`` counts each op's launches
and ``.variants`` counts them by variant.

``tile_map`` is the forward kernel's grid in plain Python: which group
and rows each row tile takes (``tests/test_torch_grouped_plan.py`` holds
it to the plain version).

Training: when an operand requires grad, ``grouped_matmul`` runs through
an autograd ``Function`` on either device: dX is the same op on
``w.transpose(-1, -2)`` (a strided view: no copy), dW is
``grouped_matmul_dw`` cast to w's dtype.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from .ref import grouped_matmul_dw_ref, grouped_matmul_ref

__all__ = ["Plan", "VARIANTS", "dw_plan", "grouped_matmul", "grouped_matmul_dw", "plan",
           "tile_map"]

VARIANTS = ("mma", "fma")
_CODES = {"fma": 0, "mma": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FMA_BM = 64  # rows a block of fma takes (csrc/grouped_matmul.cu)
_LIB = None


class Plan(NamedTuple):
    variant: str
    bm: int  # rows of one group a block takes


def plan(rows: int, n_groups: int, dtype: torch.dtype, aligned: bool) -> Plan:
    """The forward's variant and block rows for ``rows`` rows over
    ``n_groups`` groups; ``aligned``: both operands have 16-byte rows."""
    if dtype == torch.bfloat16 and aligned:
        per = rows / max(n_groups, 1)
        return Plan("mma", 32 if per <= 16 else 64 if per <= 64 else 128)
    return Plan("fma", FMA_BM)


def dw_plan(dtype: torch.dtype, aligned: bool) -> str:
    return "mma" if dtype == torch.bfloat16 and aligned else "fma"


def tile_map(group_sizes, rows: int, bm: int) -> list[tuple[int, int, int]]:
    """``(group, first row, end row)`` of each of the forward grid's
    ``ceil(rows / bm) + G`` row tiles, as the kernel's ``find_tile``
    forms them: group g's rows (sizes clamped to ``rows``) in tiles of
    ``bm`` from its first row, the groups in order; then tiles of the
    rows past the sum (group -1, zeroed); ``end <= first`` for a tile
    with nothing to do."""
    sizes = [max(int(s), 0) for s in torch.as_tensor(group_sizes).tolist()]
    tiles, off = [], 0
    for g, size in enumerate(sizes):
        a, b = min(off, rows), min(off + size, rows)
        off += size
        tiles += [(g, r, min(b, r + bm)) for r in range(a, b, bm)]
    tail = min(off, rows)
    n = -(-rows // bm) + len(sizes)
    tiles += [(-1, min(tail + j * bm, rows), min(tail + (j + 1) * bm, rows))
              for j in range(n - len(tiles))]
    return tiles


def _rows16(t: torch.Tensor, inner: int, outer: list[int]) -> bool:
    """t's unit stride on axis ``inner``, the strides of ``outer`` multiples
    of 8 elements, the base on 16 bytes."""
    return (t.stride(inner) == 1 and all(t.stride(a) % 8 == 0 or t.shape[a] == 1 for a in outer)
            and t.data_ptr() % 16 == 0)


def _w_aligned(w: torch.Tensor) -> bool:
    return _rows16(w, 2, [0, 1]) or _rows16(w, 1, [0, 2])


class _Args(ctypes.Structure):
    """``GmmArgs`` of ``csrc/grouped_matmul.cu``."""

    _fields_ = [(f, ctypes.c_longlong)
                for f in ("R", "K", "N", "G", "sxr", "sxk", "swg", "swk", "swn")] + [
        (f, ctypes.c_int) for f in ("dtype", "variant", "bm")]


class _DwArgs(ctypes.Structure):
    """``DwArgs`` of ``csrc/grouped_matmul.cu``."""

    _fields_ = [(f, ctypes.c_longlong) for f in ("R", "K", "N", "G", "sxr", "sxk", "sdr", "sdn")
                ] + [(f, ctypes.c_int) for f in ("dtype", "variant")]


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("grouped_matmul")
        lib.grouped_matmul_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.grouped_matmul_launch.restype = ctypes.c_int
        lib.grouped_matmul_dw_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.POINTER(_DwArgs), ctypes.c_void_p]
        lib.grouped_matmul_dw_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_sizes(group_sizes, n_groups, device, what):
    if (group_sizes.device != device or group_sizes.dtype != torch.int32
            or group_sizes.shape != (n_groups,) or not group_sizes.is_contiguous()):
        raise ValueError(f"{what}: group_sizes must be a contiguous ({n_groups},) int32 tensor "
                         f"on {device}; got {tuple(group_sizes.shape)} {group_sizes.dtype} on "
                         f"{group_sizes.device}")


def _check_operands(a, b, what):
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{what}: operands on {a.device} and {b.device}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"{what} kernel takes f32 or bf16 operands of one dtype; got "
                        f"{a.dtype}, {b.dtype}")


def _launch_forward(x, w, group_sizes):
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"grouped_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    _check_operands(x, w, "grouped_matmul")
    (r, k), (g, _, n) = x.shape, w.shape
    _check_sizes(group_sizes, g, x.device, "grouped_matmul")
    out = torch.empty((r, n), dtype=x.dtype, device=x.device)
    if r == 0 or n == 0:
        return out
    p = plan(r, g, x.dtype, _rows16(x, 1, [0]) and _w_aligned(w))
    dev = x.device.index
    args = _Args(r, k, n, g, *x.stride(), *w.stride(), _DTYPES[x.dtype], _CODES[p.variant], p.bm)
    lib = _lib()
    err = lib.grouped_matmul_launch(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                                    out.data_ptr(), args, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _build.check(lib, err, f"grouped_matmul ({p.variant})")
    grouped_matmul.launches += 1
    grouped_matmul.variants[p.variant] += 1
    return out


def _launch_dw(x, dy, group_sizes, force_fma=False):
    """The weight-gradient kernel on CUDA tensors; ``force_fma`` launches
    ``fma`` whatever ``dw_plan`` says (to time both variants on the same
    inputs)."""
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"grouped_matmul_dw: shapes {tuple(x.shape)}, {tuple(dy.shape)}")
    _check_operands(x, dy, "grouped_matmul_dw")
    n_groups = group_sizes.shape[0] if group_sizes.dim() == 1 else -1
    _check_sizes(group_sizes, n_groups, x.device, "grouped_matmul_dw")
    (r, k), n = x.shape, dy.shape[1]
    dw = torch.empty((n_groups, k, n), dtype=torch.float32, device=x.device)
    if k == 0 or n == 0:
        return dw
    variant = "fma" if force_fma else dw_plan(x.dtype, _rows16(x, 1, [0]) and _rows16(dy, 1, [0]))
    dev = x.device.index
    args = _DwArgs(r, k, n, n_groups, *x.stride(), *dy.stride(), _DTYPES[x.dtype],
                   _CODES[variant])
    lib = _lib()
    err = lib.grouped_matmul_dw_launch(x.data_ptr(), dy.data_ptr(), group_sizes.data_ptr(),
                                       dw.data_ptr(), args,
                                       torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _build.check(lib, err, f"grouped_matmul_dw ({variant})")
    grouped_matmul_dw.launches += 1
    grouped_matmul_dw.variants[variant] += 1
    return dw


def _forward(x, w, group_sizes):
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w, group_sizes)
    return _launch_forward(x, w, group_sizes)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``x (R, K)`` rows of group g times ``w[g]`` (w (G, K, N), any
    strides), group_sizes (G,) int32 on x's device -> (R, N) in x's
    dtype. Differentiable in x and w."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(x, w, group_sizes)
    return _forward(x, w, group_sizes)


def grouped_matmul_dw(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor
                      ) -> torch.Tensor:
    """dw[g] = x[rows of g]^T dy[rows of g], (G, K, N) f32; an empty
    group's is zero."""
    if x.device.type == "cpu":
        return grouped_matmul_dw_ref(x, dy, group_sizes)
    return _launch_dw(x, dy, group_sizes)


class _GroupedMatmul(torch.autograd.Function):
    """The grouped GEMM with dX on the same kernel (w transposed, as a
    view) and dW on ``grouped_matmul_dw``."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return _forward(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _forward(dy, w.transpose(-1, -2), group_sizes)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul_dw(x, dy, group_sizes).to(w.dtype)
        return dx, dw, None


grouped_matmul.launches = 0
grouped_matmul.variants = dict.fromkeys(VARIANTS, 0)
grouped_matmul_dw.launches = 0
grouped_matmul_dw.variants = dict.fromkeys(VARIANTS, 0)
