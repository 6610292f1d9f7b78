"""Public ops of the AdamW step: the fused leaf update and the per-leaf
sum of squares that the global-norm clip reads.

``adamw(p, g, m, v, scale, lr, bc1, bc2, ...)`` updates one f32 leaf and
its moments in place. ``sum_squares(xs)`` returns each tensor's f32 sum
of squares as one (len(xs),) f32 vector. For CPU tensors both run their
plain versions (``ref.py``). For CUDA tensors they launch the kernels of
``csrc/adamw.cu`` (built on first use), or raise: nothing falls back.
The update takes ``scale``, ``lr``, ``bc1`` and ``bc2`` as f32 scalars on
the card, read by pointer: no host sync and no host-to-device copy per
call. Given the same four tensors its result is the plain version's bit
for bit (no contraction into FMAs, the same f32 constants).

Each leaf is one launch of each kernel. ``adamw.launches`` counts both,
and ``adamw.variants`` counts them as ``update`` and ``norm``. Operands of
any strides are taken as they are (flat 16-byte accesses where all are
contiguous and aligned, strided indexing up to 8 dims otherwise); the
update raises where p, m or v overlap themselves, since it writes them.

The sums are deterministic: no float atomics; each block stores a
partial and the last block to finish sums them in a fixed order. The
partials and the int counter that finds the last block are a workspace
kept per device, zeroed once and left zeroed by every launch, so the
norm launches of one device go on one stream at a time (the train step
issues them on torch's current stream).

Meta tensors (the dry-run's accounting, ``kernels/_meta.py``) take the
CUDA branch up to the launch: charged ``work`` or ``norm_work``, counted
by the accounting and not in the launch counters.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._meta import Work, aligned16, charge, kernel_device
from .ref import adamw_ref, sum_squares_ref

__all__ = ["VARIANTS", "adamw", "norm_work", "sum_squares", "work"]

VARIANTS = ("update", "norm")
_G_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIMS = 8
_LIB = None
_WORKSPACE: dict = {}  # device -> (partials, counter)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("adamw")
        ll = ctypes.POINTER(ctypes.c_longlong)
        lib.adamw_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ll, ll]
            + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        lib.adamw_launch.restype = ctypes.c_int
        lib.sum_squares_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3 + [ll, ll]
            + [ctypes.c_void_p] * 4)
        lib.sum_squares_launch.restype = ctypes.c_int
        lib.adamw_norm_blocks_max.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def work(n: int, g_es: int) -> Work:
    """One update launch's work on a leaf of ``n`` elements: p, g, m, v
    read once and p, m, v written once (28 B an element for an f32
    gradient, 26 for bf16); 17 f32 operations an element; no matmul."""
    return Work(float(n * (24 + g_es)), 17.0 * n, 0.0)


def norm_work(n: int, es: int) -> Work:
    """One sum-of-squares launch's work: x read once, one f32 written; 2
    operations an element; no matmul."""
    return Work(float(n * es + 4), 2.0 * n, 0.0)


def _no_overlap(t) -> bool:
    """Whether no two elements of ``t`` share an address (by its strides)."""
    span = 0
    for stride, size in sorted((abs(st), s) for s, st in zip(t.shape, t.stride()) if s > 1):
        if stride <= span:
            return False
        span += (size - 1) * stride
    return True


def _layout(ts):
    """(flat, ndim, sizes, strides) of operands of one shape: ``flat`` when
    all are contiguous, else the shape and each operand's strides as
    ctypes arrays."""
    shape = ts[0].shape
    if all(t.is_contiguous() for t in ts):
        return 1, 0, None, None
    if len(shape) > _MAX_DIMS:
        raise ValueError(f"adamw kernel: {len(shape)} dims, at most {_MAX_DIMS} when strided")
    sizes = (ctypes.c_longlong * max(1, len(shape)))(*shape)
    strides = (ctypes.c_longlong * max(1, len(ts) * len(shape)))(
        *[st for t in ts for st in t.stride()])
    return 0, len(shape), sizes, strides


def _scalars(p, scalars):
    for name, s in scalars.items():
        if s.device != p.device or s.dtype != torch.float32 or s.numel() != 1:
            raise ValueError(f"adamw kernel: {name} must be one f32 on {p.device}; got "
                             f"{tuple(s.shape)} {s.dtype} on {s.device}")


def adamw(p, g, m, v, scale, lr, bc1, bc2, *, b1: float, b2: float, eps: float,
          weight_decay: float) -> None:
    """One leaf's AdamW step in place on ``p``, ``m``, ``v`` (f32, one
    shape; ``g`` f32 or bf16), as ``adamw_ref`` states it."""
    if p.device.type == "cpu":
        return adamw_ref(p, g, m, v, scale, lr, bc1, bc2, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay)
    if not kernel_device(p) or any(t.device != p.device for t in (g, m, v)):
        raise ValueError(f"adamw: tensors on {p.device}, {g.device}, {m.device}, {v.device}")
    if not p.dtype == m.dtype == v.dtype == torch.float32 or g.dtype not in _G_CODES:
        raise TypeError(f"adamw kernel: f32 p, m, v and an f32 or bf16 g; got {p.dtype}, "
                        f"{g.dtype}, {m.dtype}, {v.dtype}")
    if not p.shape == g.shape == m.shape == v.shape:
        raise ValueError(f"adamw kernel: shapes {tuple(p.shape)}, {tuple(g.shape)}, "
                         f"{tuple(m.shape)}, {tuple(v.shape)}")
    if not all(_no_overlap(t) for t in (p, m, v)):
        raise ValueError("adamw kernel: p, m and v are written in place and may not overlap "
                         "themselves")
    _scalars(p, {"scale": scale, "lr": lr, "bc1": bc1, "bc2": bc2})
    n = p.numel()
    if n == 0:
        return None
    if p.device.type == "meta":
        charge("adamw", "update", work(n, g.element_size()))
        return None
    ts = (p, g, m, v)
    flat, ndim, sizes, strides = _layout(ts)
    vec = int(bool(flat) and aligned16(p, m, v) and g.data_ptr() % (4 * g.element_size()) == 0)
    lib = _lib()
    err = lib.adamw_launch(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n, _G_CODES[g.dtype], flat, vec,
        ndim, sizes, strides, scale.data_ptr(), lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
        b1, b2, 1 - b1, 1 - b2, eps, weight_decay,
        torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(lib, err, "adamw (update)")
    adamw.launches += 1
    adamw.variants["update"] += 1
    return None


def _workspace(device):
    ws = _WORKSPACE.get(device)
    if ws is None:
        n = _lib().adamw_norm_blocks_max()
        ws = _WORKSPACE[device] = (torch.zeros(n, dtype=torch.float32, device=device),
                                   torch.zeros(1, dtype=torch.int32, device=device))
    return ws


def sum_squares(xs):
    """Each tensor's f32 sum of squares, as one (len(xs),) f32 vector on
    their device: one launch a tensor on the card, each writing its slot."""
    xs = list(xs)
    if xs[0].device.type == "cpu":
        return sum_squares_ref(xs)
    dev = xs[0].device
    if not kernel_device(xs[0]) or any(x.device != dev for x in xs):
        raise ValueError(f"sum_squares: tensors on {sorted({str(x.device) for x in xs})}")
    for x in xs:
        if x.dtype not in _G_CODES:
            raise TypeError(f"sum_squares kernel takes f32 or bf16; got {x.dtype}")
    out = torch.empty(len(xs), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        for x in xs:
            charge("adamw", "norm", norm_work(x.numel(), x.element_size()))
        return out
    lib = _lib()
    partials, counter = _workspace(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i, x in enumerate(xs):
        flat, ndim, sizes, strides = _layout((x,))
        err = lib.sum_squares_launch(
            x.data_ptr(), x.numel(), _G_CODES[x.dtype], flat, ndim, sizes, strides,
            partials.data_ptr(), counter.data_ptr(), out.data_ptr() + 4 * i, stream)
        _build.check(lib, err, "adamw (norm)")
        adamw.launches += 1
        adamw.variants["norm"] += 1
    return out


adamw.launches = 0
adamw.variants = dict.fromkeys(VARIANTS, 0)
