"""Public op: the dOS matmul, dispatched by the device of its operands.

For CPU tensors the op runs its plain version (``matmul_ref``). For CUDA
tensors it launches one of the hand-written kernels of
``csrc/dos_matmul.cu`` (built on first use), or raises: nothing falls
back. ``plan`` picks the kernel and its tiling from the shape, before
the launch:

- ``skinny``: bf16, M <= 16 (decode). Bytes bound it; a block takes 4
  rows of A, N is tiled and K split over a thread-block cluster until
  the grid has ~1.5 blocks per SM.
- ``wgmma``: bf16, M > 16, when TMA can describe A and B (16-byte aligned
  bases, K and B's leading dimension multiples of 8). The tensor cores
  bound it; BN and a cluster split of K come from a wave model of the
  card's SMs.
- ``general``: bf16, M > 16, operands TMA cannot describe; and bf16
  operands asked for an f32 output (skinny and wgmma store bf16 only).
- ``f32``: f32 operands.

The reference's padding to block multiples, its ``MIN_TILE_*`` dispatch
of small shapes to the plain GEMM and its VMEM-sized ``pick_blocks`` are
TPU facts and have no counterpart: the kernels mask ragged edges
themselves, so every shape goes through one of them.

``dos_matmul.launches`` counts the kernel launches of this process and
``dos_matmul.variants`` counts them by variant.

Training: when an operand requires grad, a CUDA call runs through an
autograd ``Function`` whose backward launches the same kernel twice,
dA = dC B^T (B^T a transposed view, which the kernel reads as it is)
and dB = A^T dC (A^T copied to a contiguous matrix first), each in its
operand's dtype, as the reference's autodiff of ``matmul_ref`` gives
them. On the CPU, ``matmul_ref`` runs under torch's autograd.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .. import _build
from .ref import matmul_ref

__all__ = ["Plan", "VARIANTS", "dos_matmul", "plan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("skinny", "wgmma", "general", "f32")
_CODES = {"general": 0, "skinny": 1, "wgmma": 2, "f32": 3}
_LIB = None

N_SM = 132            # streaming multiprocessors of an H100 SXM: the default
MAX_CLUSTER = 8       # blocks of a thread-block cluster (the portable limit)
SKINNY_MAX_M = 16
SKINNY_BM = 4         # rows of A per skinny block; M <= 16 takes ceil(M / 4) of them

W_BM, W_BK = 128, 64  # wgmma: rows of A per block, K per pipeline stage
# wgmma's block time on the H100 (fitted to `chip_smoke.py --sweep`):
# us per 64-deep k-tile by BN, a fixed cost per block, and a cost per
# extra block of a K split (the cluster's reduction). A wgmma block fills
# its SM, and clusters of such blocks measured slow wherever the grid had
# more than a few dozen of them, so K is split only for grids of at most
# 8 tiles (2560x64 at M = 512 is 4).
_W_TILE_US = {64: 0.38, 128: 0.5, 192: 0.66, 256: 0.85}
_W_BLOCK_US = 2.0
_W_SPLIT_US = 1.5
_W_SPLIT_MAX_TILES = 8
_W_MAX_SPLIT = 4
_W_MIN_SPLIT_TILES = 12  # k-tiles a block of a split takes at least


def skinny_max_blocks(n_sm: int) -> int:
    """Skinny blocks per grid the K split aims at. Two fit on an SM (256
    threads, <= 128 registers), but `chip_smoke.py --sweep` measured grids
    of up to 200 blocks on the H100's 132 SMs fastest: past that, clusters
    wait for free SMs of one GPC and part of the grid runs as a second
    wave. Another card gets the same share of its SMs."""
    return 200 * n_sm // N_SM


class Plan(NamedTuple):
    """A launch: the variant, rows and columns per block, the number of
    blocks of a cluster that split K, and the K rows each takes (the
    last one takes what is left)."""

    variant: str
    bm: int
    bn: int
    split: int
    k_chunk: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan_skinny(m: int, n: int, k: int, b_transposed: bool, n_sm: int) -> Plan:
    bn = 64 if b_transposed or n <= 4096 else 128
    tiles = _cdiv(n, bn) * _cdiv(m, SKINNY_BM)
    # as many splits as keep the grid within skinny_max_blocks, each split
    # keeping >= 64 rows of K
    split = max(1, min(MAX_CLUSTER, skinny_max_blocks(n_sm) // tiles, k // 64))
    k_chunk = max(8, _cdiv(_cdiv(k, split), 8) * 8)  # 16-byte vectors stay inside a split
    return Plan("skinny", SKINNY_BM, bn, max(1, _cdiv(k, k_chunk)), k_chunk)


def _plan_wgmma(m: int, n: int, k: int, n_sm: int) -> Plan:
    """BN and K split by the least modelled time: waves of ``n_sm``
    blocks, each taking its k-tiles at BN's rate."""
    m_tiles, k_tiles = _cdiv(m, W_BM), _cdiv(k, W_BK)
    best = None
    for bn in (256, 192, 128, 64):  # 192: 2560x5120 at M = 512 is 108 tiles, one wave
        tiles = m_tiles * _cdiv(n, bn)
        for split in range(1, _W_MAX_SPLIT + 1):
            per = _cdiv(k_tiles, split)
            if split > 1 and (tiles > _W_SPLIT_MAX_TILES or per < _W_MIN_SPLIT_TILES
                              or _cdiv(k_tiles, per) < split):
                break
            block_us = _W_TILE_US[bn] * per + _W_BLOCK_US + _W_SPLIT_US * (split - 1)
            cost = _cdiv(tiles * split, n_sm) * block_us
            if best is None or cost < best[0]:
                best = (cost, bn, split, per)
    _, bn, split, per = best
    return Plan("wgmma", W_BM, bn, split, per * W_BK)


def plan(m: int, n: int, k: int, dtype: torch.dtype, ldb: int, b_transposed: bool,
         aligned: bool, out_dtype: torch.dtype | None = None, n_sm: int = N_SM) -> Plan:
    """The kernel and tiling for ``A(m, k) @ B(k, n)``. ``ldb`` is B's
    leading dimension (the stride of its non-unit axis), ``b_transposed``
    says B's unit stride runs along k, ``aligned`` that both bases are
    16-byte aligned, ``out_dtype`` (default ``dtype``) the output's type
    and ``n_sm`` the card's SM count."""
    if dtype == torch.float32:
        return Plan("f32", 64, 64, 1, k)
    if (out_dtype or dtype) != dtype:
        return Plan("general", 64, 64, 1, k)
    if m <= SKINNY_MAX_M:
        return _plan_skinny(m, n, k, b_transposed, n_sm)
    if aligned and k > 0 and k % 8 == 0 and ldb % 8 == 0:
        return _plan_wgmma(m, n, k, n_sm)
    return Plan("general", 64, 64, 1, k)


class _Launch(ctypes.Structure):
    """``DosLaunch`` of ``csrc/dos_matmul.cu``: a shape and its plan."""

    _fields_ = [(f, ctypes.c_longlong) for f in ("m", "n", "k", "sbk", "sbn")] + [
        (f, ctypes.c_int)
        for f in ("in_dtype", "out_dtype", "variant", "bm", "bn", "split", "k_chunk")
    ]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# The decode step repeats a few shapes, so a call looks its launch up in
# a bounded cache rather than planning it again.
@functools.lru_cache(maxsize=256)
def _launch(m, n, k, sbk, sbn, dtype, out_dtype, aligned, device_index):
    """(variant, _Launch) of one shape on one card."""
    b_t = sbn != 1
    p = plan(m, n, k, dtype, sbn if b_t else sbk, b_t, aligned, out_dtype,
             _sm_count(device_index))
    args = _Launch(m, n, k, sbk, sbn, _DTYPES[dtype], _DTYPES[out_dtype], _CODES[p.variant],
                   p.bm, p.bn, p.split, p.k_chunk)
    return p.variant, args


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("dos_matmul")
        lib.dos_matmul_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.POINTER(_Launch), ctypes.c_void_p]
        )
        lib.dos_matmul_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def dos_matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """``a(..., M, K) @ b(K, N)`` with f32 accumulation.

    Leading dims of ``a`` are flattened into M. ``b`` may be a row-major
    matrix or a transposed view (the tied unembedding passes the
    embedding table's ``.T``). Differentiable when an operand requires
    grad.
    """
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _DosMatmul.apply(a, b, out_dtype)
    return _launch_kernel(a, b, out_dtype)


class _DosMatmul(torch.autograd.Function):
    """The dOS matmul with its two gradient products on the same kernel."""

    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return _launch_kernel(a, b, out_dtype)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        # the kernel takes operands of one dtype: dC in A's (the reference's
        # cotangent of a bf16 output is bf16 already)
        dc = dc.reshape(-1, b.shape[1]).to(a.dtype).contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _launch_kernel(dc, b.T, a.dtype).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            a2 = a.reshape(-1, a.shape[-1])
            db = _launch_kernel(a2.T.contiguous(), dc.to(b.dtype), b.dtype)
        return da, db, None


def _launch_kernel(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """One launch of the kernel on CUDA operands (the wrapper's body)."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"dos_matmul: operands on {a.device} and {b.device}")
    if b.dim() != 2 or a.shape[-1] != b.shape[0]:
        raise ValueError(f"dos_matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    sbk, sbn = b.stride()
    if sbk != 1 and sbn != 1:
        raise ValueError(f"dos_matmul kernel needs a unit stride in B; got {b.stride()}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(
            f"dos_matmul kernel takes f32 or bf16 operands of one dtype and an "
            f"f32 or bf16 output; got {a.dtype}, {b.dtype} -> {out_dtype}"
        )
    # The decode step calls this a few hundred times per token, so the
    # host path is kept short: A is passed as its (M, K) storage without a
    # reshape, the output is allocated in its final shape, and the stream
    # is read as a raw handle.
    lead = a.shape[:-1]
    k, n = b.shape
    if not a.is_contiguous():
        a = a.contiguous()
    m = a.numel() // k if k else math.prod(lead)
    out = torch.empty((*lead, n), dtype=out_dtype, device=a.device)
    if m and n:
        pa, pb, dev = a.data_ptr(), b.data_ptr(), a.device.index
        variant, args = _launch(m, n, k, sbk, sbn, a.dtype, out_dtype, (pa | pb) % 16 == 0, dev)
        lib = _lib()
        err = lib.dos_matmul_launch(pa, pb, out.data_ptr(), args,
                                    torch._C._cuda_getCurrentRawStream(dev))
        if err:
            _build.check(lib, err, f"dos_matmul ({variant})")
        dos_matmul.launches += 1
        dos_matmul.variants[variant] += 1
    return out


dos_matmul.launches = 0
dos_matmul.variants = dict.fromkeys(VARIANTS, 0)
