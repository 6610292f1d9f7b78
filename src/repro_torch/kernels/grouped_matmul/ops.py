"""Public ops: the grouped GEMM of the MoE experts and its weight
gradient, dispatched by the device of their operands.

``grouped_matmul(x, w, group_sizes)`` is the reference's
``jax.lax.ragged_dot``: x (R, K) with its rows sorted by group, w (G, K,
N), group_sizes (G,) int32; rows of group g multiply w[g], rows past the
sum of the sizes are zero; f32 sums, output in x's type or in the
``out_dtype`` asked for (f32: a mesh's K-split or row-parallel partial,
summed over ranks before its cast; every variant writes it from its f32
accumulators, ``wgmma`` from registers).
``grouped_matmul_dw(x, dy, group_sizes, out_dtype)`` is its weight
gradient, (G, K, N), each f32 sum rounded once to ``out_dtype`` (f32 by
default).

For CPU tensors each op runs its plain version (``ref.py``). For CUDA
tensors it launches a hand-written kernel of ``csrc/grouped_matmul.cu``
(built on first use), or raises: nothing falls back. The sizes stay on
the device: the kernel forms the offsets, so a call never waits for the
host. ``plan`` picks the variant before the launch, from shapes, dtypes
and layouts:

- ``wgmma``: bf16 operands that TMA can describe (``_tma``: a unit inner
  stride, the other strides multiples of 8 elements, 16-byte aligned
  bases; w with a unit stride along n, or along k as in
  ``w.transpose(-1, -2)``) over at most ``WGMMA_MAX_GROUPS`` groups: TMA
  and ``wgmma`` in persistent blocks, BM rows of one group a tile (64 up
  to ``WGMMA_BM64_ROWS`` rows a group on average, else 128).
- ``fma``: f32 operands, bf16 ones TMA cannot describe, and more groups
  than the wgmma kernel's tile list holds: f32 FMAs, any strides.

The block rows are phase 15's and ``tools/gmm_variants.py``'s
measurements on an H100 (PERF.md): 64-row tiles at deepseek-moe-16b's
decode (1-2 rows a group) and prefill (48), 128-row tiles in training
(384). ``wgmma`` was as fast as an ``mma.sync`` kernel or faster at every
one of these shapes, so no such kernel is kept. ``grouped_matmul_dw``
takes ``wgmma`` where TMA can describe x and dy (and dw's rows lie on 16
bytes) over at most ``WGMMA_MAX_GROUPS`` groups, ``fma`` otherwise (the
forward's rule). The private ``_launch_forward(..., force=)`` and
``_launch_dw(..., force=)`` launch a named variant whatever the plan
says, to check and time every variant on the same inputs. ``.launches``
counts each op's launches and ``.variants`` counts them by variant.

``tile_map`` is the ``fma`` forward kernel's grid in plain Python,
``tile_list`` the ``wgmma`` forward's list of tiles and ``dw_stages`` the
``wgmma`` dW's row stages with their masks
(``tests/test_torch_grouped_plan.py`` holds each to the plain version).

Training: when an operand requires grad, ``grouped_matmul`` runs through
an autograd ``Function`` on either device: dX is the same op on
``w.transpose(-1, -2)`` (a strided view: no copy), dW is
``grouped_matmul_dw`` in w's dtype. The incoming gradient of an f32
output is cast to x's dtype first, as ``dos_matmul``'s is.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from .ref import group_bounds, grouped_matmul_dw_ref, grouped_matmul_ref

__all__ = ["Plan", "VARIANTS", "dw_plan", "dw_stages", "grouped_matmul", "grouped_matmul_dw",
           "plan", "tile_list", "tile_map"]

VARIANTS = ("wgmma", "fma")
_CODES = {"fma": 0, "wgmma": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FMA_BM = 64  # rows a block of fma takes (csrc/grouped_matmul.cu)
WGMMA_MAX_GROUPS = 512  # the wgmma kernels' tile list in shared memory (W_MAX_G)
WGMMA_BM64_ROWS = 64  # rows a group on average up to which wgmma tiles are 64 rows
DW_ROWS = 64  # rows of x and dy a stage of the wgmma dW (DwCfg::BR)
_LIB = None


class Plan(NamedTuple):
    variant: str
    bm: int  # rows of one group a block (a tile) takes


def _wgmma(dtype: torch.dtype, aligned: bool, n_groups: int) -> bool:
    return dtype == torch.bfloat16 and aligned and n_groups <= WGMMA_MAX_GROUPS


def plan(rows: int, n_groups: int, dtype: torch.dtype, aligned: bool) -> Plan:
    """The forward's variant and block rows for ``rows`` rows over
    ``n_groups`` groups; ``aligned``: TMA can describe both operands."""
    return _forced("wgmma" if _wgmma(dtype, aligned, n_groups) else "fma", rows, n_groups)


def _forced(variant: str, rows: int, n_groups: int) -> Plan:
    if variant == "fma":
        return Plan("fma", FMA_BM)
    return Plan("wgmma", 64 if rows / max(n_groups, 1) <= WGMMA_BM64_ROWS else 128)


def dw_plan(dtype: torch.dtype, aligned: bool, n_groups: int = 1) -> str:
    """dW's variant, by the forward's rule; ``aligned``: TMA can describe
    x and dy."""
    return "wgmma" if _wgmma(dtype, aligned, n_groups) else "fma"


def tile_map(group_sizes, rows: int, bm: int) -> list[tuple[int, int, int]]:
    """``(group, first row, end row)`` of each of the ``fma`` forward grid's
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


def tile_list(group_sizes, rows: int, bm: int, n: int, bn: int
              ) -> list[tuple[int, int, int, int]]:
    """``(group, first row, end row, first column)`` of each tile of the
    ``wgmma`` forward's list, in the order the persistent blocks take
    them (tile t to block t % grid), as the kernel's ``group_list`` and
    ``fwd_tile`` form them: the groups in order, an empty group owning
    none; inside a group its ``ceil(n / bn)`` column tiles in order and,
    inside each, the group's rows (sizes clamped to ``rows``) in tiles of
    ``bm`` from its first row; then tiles of the rows past the sum (group
    -1, zeroed), ``bm`` rows by ``bn`` columns each."""
    sizes = [max(int(s), 0) for s in torch.as_tensor(group_sizes).tolist()]
    n_tiles = -(-n // bn)
    tiles, off = [], 0
    for g, size in enumerate(sizes):
        a, b = min(off, rows), min(off + size, rows)
        off += size
        tiles += [(g, r, min(b, r + bm), j * bn) for j in range(n_tiles) for r in range(a, b, bm)]
    tail = min(off, rows)
    tiles += [(-1, r, min(rows, r + bm), j * bn) for r in range(tail, rows, bm)
              for j in range(n_tiles)]
    return tiles


def dw_stages(group_sizes, rows: int) -> list[list[tuple[int, int]]]:
    """The ``wgmma`` dW's row stages of each group: ``(first row, rows of
    the group)`` of each stage of ``DW_ROWS`` rows from the group's first
    row (sizes clamped to ``rows``). A stage's rows past the group's, which
    belong to the next group, are zeroed before the product; rows past
    ``rows`` are zero (TMA's fill)."""
    return [[(r, min(DW_ROWS, b - r)) for r in range(a, b, DW_ROWS)]
            for a, b in group_bounds(group_sizes, rows)]


def _rows16(t: torch.Tensor, inner: int, outer: list[int]) -> bool:
    """t's unit stride on axis ``inner``, the strides of ``outer`` multiples
    of 8 elements, the base on 16 bytes."""
    return (t.stride(inner) == 1 and all(t.stride(a) % 8 == 0 or t.shape[a] == 1 for a in outer)
            and t.data_ptr() % 16 == 0)


def _tma(t: torch.Tensor, inner: int, outer: list[int]) -> bool:
    """A tensor map (TMA) can describe t: 16-byte rows (``_rows16``), every
    stride below 2**40 bytes and every extent below 2**31."""
    return (_rows16(t, inner, outer) and all(t.shape[a] < 2**31 for a in range(t.dim()))
            and all(t.stride(a) * t.element_size() < 2**40 for a in outer))


def _w_tma(w: torch.Tensor) -> bool:
    return _tma(w, 2, [0, 1]) or _tma(w, 1, [0, 2])


class _Args(ctypes.Structure):
    """``GmmArgs`` of ``csrc/grouped_matmul.cu``."""

    _fields_ = [(f, ctypes.c_longlong)
                for f in ("R", "K", "N", "G", "sxr", "sxk", "swg", "swk", "swn")] + [
        (f, ctypes.c_int) for f in ("dtype", "variant", "bm", "out_dtype")]


class _DwArgs(ctypes.Structure):
    """``DwArgs`` of ``csrc/grouped_matmul.cu``."""

    _fields_ = [(f, ctypes.c_longlong) for f in ("R", "K", "N", "G", "sxr", "sxk", "sdr", "sdn")
                ] + [(f, ctypes.c_int) for f in ("dtype", "variant", "out_dtype")]


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


def _check_force(force, dtype, tma, what):
    if force not in (None,) + VARIANTS:
        raise ValueError(f"{what}: no variant {force!r}; one of {VARIANTS}")
    if force == "wgmma" and not (dtype == torch.bfloat16 and tma):
        raise ValueError(f"{what}: wgmma takes bf16 operands that TMA can describe, over at "
                         f"most {WGMMA_MAX_GROUPS} groups")


def _launch_forward(x, w, group_sizes, force=None, bm=0, out_dtype=None):
    """The forward kernel on CUDA tensors, out in ``out_dtype`` (f32 or
    x's dtype; default x's); ``force`` launches that variant whatever
    ``plan`` says (to check and time every variant on the same inputs),
    ``bm`` its block rows other than the plan's (wgmma 64 or 128; 0: the
    plan's)."""
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"grouped_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    _check_operands(x, w, "grouped_matmul")
    (r, k), (g, _, n) = x.shape, w.shape
    _check_sizes(group_sizes, g, x.device, "grouped_matmul")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"grouped_matmul writes f32 or x's {x.dtype}; got {out_dtype}")
    out = torch.empty((r, n), dtype=out_dtype, device=x.device)
    if r == 0 or n == 0:
        return out
    tma = k > 0 and _tma(x, 1, [0]) and _w_tma(w)
    _check_force(force, x.dtype, tma and g <= WGMMA_MAX_GROUPS, "grouped_matmul")
    p = _forced(force, r, g) if force else plan(r, g, x.dtype, tma)
    p = p._replace(bm=bm or p.bm)
    dev = x.device.index
    args = _Args(r, k, n, g, *x.stride(), *w.stride(), _DTYPES[x.dtype], _CODES[p.variant], p.bm,
                 _DTYPES[out_dtype])
    lib = _lib()
    err = lib.grouped_matmul_launch(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                                    out.data_ptr(), args, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _build.check(lib, err, f"grouped_matmul ({p.variant})")
    grouped_matmul.launches += 1
    grouped_matmul.variants[p.variant] += 1
    return out


def _launch_dw(x, dy, group_sizes, force=None, out_dtype=torch.float32):
    """The weight-gradient kernel on CUDA tensors, dw in ``out_dtype`` (f32
    or bf16); ``force`` as ``_launch_forward``'s."""
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"grouped_matmul_dw: shapes {tuple(x.shape)}, {tuple(dy.shape)}")
    _check_operands(x, dy, "grouped_matmul_dw")
    if out_dtype not in _DTYPES:
        raise TypeError(f"grouped_matmul_dw writes f32 or bf16; got {out_dtype}")
    n_groups = group_sizes.shape[0] if group_sizes.dim() == 1 else -1
    _check_sizes(group_sizes, n_groups, x.device, "grouped_matmul_dw")
    (r, k), n = x.shape, dy.shape[1]
    dw = torch.empty((n_groups, k, n), dtype=out_dtype, device=x.device)
    if k == 0 or n == 0:
        return dw
    if r == 0:  # no rows: every group is empty
        return dw.zero_()
    # the kernel's TMA stores need dw's rows on 16 bytes
    tma = _tma(x, 1, [0]) and _tma(dy, 1, [0]) and n * dw.element_size() % 16 == 0
    _check_force(force, x.dtype, tma and n_groups <= WGMMA_MAX_GROUPS, "grouped_matmul_dw")
    variant = force or dw_plan(x.dtype, tma, n_groups)
    dev = x.device.index
    args = _DwArgs(r, k, n, n_groups, *x.stride(), *dy.stride(), _DTYPES[x.dtype],
                   _CODES[variant], _DTYPES[out_dtype])
    lib = _lib()
    err = lib.grouped_matmul_dw_launch(x.data_ptr(), dy.data_ptr(), group_sizes.data_ptr(),
                                       dw.data_ptr(), args,
                                       torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _build.check(lib, err, f"grouped_matmul_dw ({variant})")
    grouped_matmul_dw.launches += 1
    grouped_matmul_dw.variants[variant] += 1
    return dw


def _forward(x, w, group_sizes, out_dtype=None):
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w, group_sizes, out_dtype)
    return _launch_forward(x, w, group_sizes, out_dtype=out_dtype)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x (R, K)`` rows of group g times ``w[g]`` (w (G, K, N), any
    strides), group_sizes (G,) int32 on x's device -> (R, N) in
    ``out_dtype`` (x's dtype, the default, or f32). Differentiable in x
    and w."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(x, w, group_sizes, out_dtype)
    return _forward(x, w, group_sizes, out_dtype)


def grouped_matmul_dw(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dw[g] = x[rows of g]^T dy[rows of g], (G, K, N), each f32 sum
    rounded once to ``out_dtype``; an empty group's is zero."""
    if x.device.type == "cpu":
        return grouped_matmul_dw_ref(x, dy, group_sizes, out_dtype)
    return _launch_dw(x, dy, group_sizes, out_dtype=out_dtype)


class _GroupedMatmul(torch.autograd.Function):
    """The grouped GEMM with dX on the same kernel (w transposed, as a
    view) and dW on ``grouped_matmul_dw``."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, out_dtype):
        ctx.save_for_backward(x, w, group_sizes)
        return _forward(x, w, group_sizes, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        # the kernels take operands of one dtype: an f32 output's gradient in x's
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _forward(dy, w.transpose(-1, -2), group_sizes)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul_dw(x, dy, group_sizes, w.dtype)
        return dx, dw, None, None


grouped_matmul.launches = 0
grouped_matmul.variants = dict.fromkeys(VARIANTS, 0)
grouped_matmul_dw.launches = 0
grouped_matmul_dw.variants = dict.fromkeys(VARIANTS, 0)
