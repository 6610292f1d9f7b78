"""Public attention ops used by the model.

``flash_attention``: prefill attention over whole sequences. For CPU
tensors it runs the plain ``attention_ref``; for CUDA tensors it
launches one of the hand-written kernels of ``csrc/flash_attention.cu``
(built on first use), or raises: nothing falls back. ``plan`` picks the
kernel before the launch, from dtype, head dim and layout alone:

- ``mma``: bf16 operands whose rows start on 16 bytes (unit stride on
  the head dim, the other strides multiples of 8 elements, 16-byte
  aligned bases): the tensor-core kernel. Both serving paths and
  training run it.
- ``fma``: f32 operands, and bf16 layouts ``mma`` cannot take: the f32
  CUDA-core kernel.

``flash_attention.launches`` counts the kernel launches of this process
and ``flash_attention.variants`` counts them by variant.

Training: when an input requires grad, ``flash_attention`` runs through
an autograd ``Function``. Its forward asks the kernel for each row's
log-sum-exp as well (``lse``, (B, H, Sq) f32) and saves (q, k, v, o,
lse); its backward calls ``flash_attention_bwd``, which launches the
hand-written backward of ``csrc/flash_attention_bwd.cu`` for CUDA
tensors, picked by the same ``plan`` over q, k, v, o and dO: ``mma``
(the tensor-core kernels; training's bf16 steps run it) or ``fma`` (f32
on the CUDA cores). ``flash_attention_bwd.variants`` counts its launches
by variant. On CPU tensors the Function's forward and backward are the
plain ``attention_fwd_ref`` and ``attention_bwd_ref``. Without grad
(serving, calibration) nothing changes: no lse is stored, and the
launches are those of the forward.

Meta tensors (the dry-run's accounting, ``kernels/_meta.py``) take the
CUDA branch up to the launch: planned and charged ``work`` (or
``bwd_work``) with their variant, counted by the accounting and not in
the launch counters. The charged FLOPs are the plain versions' dense S = QK^T
and PV (and the backward's five products), whatever the mask hides.

``decode_attention``: one query token against a KV cache. It is not a
Pallas kernel in the JAX package either (a batched GEMV that XLA
compiles). For CPU tensors it runs the plain ``decode_attention_ref``;
for CUDA tensors it launches the split-KV kernel of
``csrc/decode_attention.cu`` (``split_plan`` picks the number of slices
from the shapes alone; above one slice a second launch joins them), or
raises. ``length`` is an int, passed by value, or a per-batch integer
tensor already on q's device, read by the kernel: no host sync and no
host-to-device copy per call. A q whose dtype is not the cache's is read
as it is (no promotion): q' rounds to q's dtype, the cache is read in its
own. ``decode_attention.launches`` counts calls that launched (one
``split`` a call, whatever its number of slices); meta tensors are
charged ``decode_work``.
"""

from __future__ import annotations

import ctypes
import math
import numbers

import torch

from .. import _build
from .._meta import Work, aligned16, charge, einsum_flops, kernel_device, visible_pairs
from .ref import attention_bwd_ref, attention_fwd_ref, attention_ref, decode_attention_ref

__all__ = ["HEAD_DIMS", "VARIANTS", "flash_attention", "flash_attention_bwd", "decode_attention",
           "plan", "work", "bwd_work", "decode_work", "split_plan", "visible_slots"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128, 256)  # built for both variants
VARIANTS = ("mma", "fma")  # of the forward and of the backward
_CODES = {"fma": 0, "mma": 1}
_NO_WINDOW = 2**62  # wider than any sequence: no window mask
_LIB = None
_BWD_LIB = None
_DECODE_LIB = None
# decode: slots a tile; blocks a call aims at (two per SM of an H100's 132);
# the largest GQA group a block takes (csrc/decode_attention.cu)
_DECODE_TILE, _DECODE_BLOCKS, _DECODE_MAX_GROUP = 128, 264, 16
_LENGTH_DTYPES = {torch.int32: 0, torch.int64: 1}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.flash_attention_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load("flash_attention_bwd")
        lib.flash_attention_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
               ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p]
        )
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        _BWD_LIB = lib
    return _BWD_LIB


def _decode_lib() -> ctypes.CDLL:
    global _DECODE_LIB
    if _DECODE_LIB is None:
        lib = _build.load("decode_attention")
        lib.decode_attention_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 10
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
               ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.decode_attention_launch.restype = ctypes.c_int
        _DECODE_LIB = lib
    return _DECODE_LIB


def plan(dtype: torch.dtype, head_dim: int, strides, aligned: bool) -> str:
    """The kernel variant for one call, forward or backward. ``strides``
    holds the (b, s, h, d) element strides of the operands (q, k and v;
    the backward adds o and dO); ``aligned`` says that their bases are
    16-byte aligned. Raises for what neither variant takes: a dtype
    other than f32 and bf16, a head dim not in ``HEAD_DIMS``, or a head
    dim whose stride is not 1."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes f32 or bf16; got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {head_dim} must be one of {HEAD_DIMS}")
    if any(st[3] != 1 for st in strides):
        raise ValueError("flash_attention kernel needs a unit stride on the head dim")
    if (dtype == torch.bfloat16 and aligned
            and all(x % 8 == 0 for st in strides for x in st[:3])):
        return "mma"
    return "fma"


def work(b, sq, skv, h, kvh, d, es, causal=True, window=None, q_offset=0,
         with_lse=False) -> Work:
    """One forward launch's work: q, k, v read once and o (and the f32
    lse) written once, 4 D operations per visible (query, key) pair and
    query head; the plain version's FLOPs are its two dense einsums, 4 B H
    Sq Skv D."""
    pairs = visible_pairs(sq, skv, causal, window, q_offset)
    full = b * h * sq * skv * d
    return Work((2 * b * sq * h + 2 * b * skv * kvh) * d * es + 4 * b * h * sq * with_lse,
                4.0 * b * h * d * pairs, einsum_flops((d, full), (skv, full)))


def bwd_work(b, sq, skv, h, kvh, d, es, causal=True, window=None, q_offset=0) -> Work:
    """One backward launch's work: q, k, v, o, dO and lse read once; dq,
    dk, dv written once; S, dP, dV, dQ and dK, 2 D operations each per
    visible (query, key) pair and query head, and 2 D per key of dV for a
    row that sees no key. The plain version's FLOPs are its five dense
    einsums, 10 B H Sq Skv D."""
    pairs = visible_pairs(sq, skv, causal, window, q_offset)
    dead = visible_pairs(sq, skv, causal, window, q_offset, dead=True)
    full, g = b * h * sq * skv * d, h // kvh
    return Work((4 * b * sq * h + 4 * b * skv * kvh) * d * es + 4 * b * h * sq,
                float(b * h * d * (10 * pairs + 2 * skv * dead)),
                einsum_flops((d, full), (sq * g, full), (d, full), (skv, full), (sq * g, full)))


def _check_qkv(q, k, v, what):
    """Device, dtype and shape checks of a kernel call; returns the head dim."""
    b, _, h, d = q.shape
    _, _, kvh, _ = k.shape
    if not kernel_device(q) or k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: tensors on {q.device}, {k.device}, {v.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes q, k, v of one dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{what} kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    return d


def _forward(q, k, v, *, causal, window, scale, q_offset, with_lse):
    """The forward kernel on CUDA tensors: ``(o, lse)``, lse None unless
    ``with_lse``."""
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    _check_qkv(q, k, v, "flash_attention")
    variant = plan(q.dtype, d, (q.stride(), k.stride(), v.stride()), aligned16(q, k, v))
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if b and sq and h:
        if skv == 0:
            raise ValueError("flash_attention: empty key sequence")
        if q.device.type == "meta":
            charge("flash_attention", variant, work(b, sq, skv, h, kvh, d, q.element_size(),
                                                    causal, window, q_offset, with_lse))
            return o, lse
        lib = _lib()
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, h, kvh, sq, skv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            scale, int(bool(causal)), _NO_WINDOW if window is None else int(window),
            int(q_offset), _DTYPES[q.dtype], _CODES[variant],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.check(lib, err, f"flash_attention ({variant})")
        flash_attention.launches += 1
        flash_attention.variants[variant] += 1
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """Attention with the flash-2 backward: the forward saves (q, k, v, o,
    lse); the backward recomputes p from lse (``flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
        if q.device.type == "cpu":
            o, lse = attention_fwd_ref(q, k, v, **kw)
        else:
            o, lse = _forward(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None, q_offset: int = 0):
    """q (B, Sq, H, D); k, v (B, Skv, KVH, D) -> (B, Sq, H, D).

    ``window`` and ``q_offset`` are Python ints (the port runs its layers
    in a Python loop, so a layer's window is never a traced value).
    Differentiable when an input requires grad. Operands of different
    dtypes (bf16 queries over f32 cross-attention keys, as the reference
    gives with f32 image embeddings in a bf16 model) run the kernel in
    their promoted dtype and return q's, as the plain version does.
    """
    if kernel_device(q) and not q.dtype == k.dtype == v.dtype:
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
        return flash_attention(q.to(dt), k.to(dt), v.to(dt), causal=causal, window=window,
                               scale=scale, q_offset=q_offset).to(q.dtype)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale, q_offset)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                             q_offset=q_offset)
    return _forward(q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset,
                    with_lse=False)[0]


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int | None = None, scale: float | None = None,
                        q_offset: int = 0):
    """``(dq, dk, dv)`` of ``flash_attention`` from its output ``o``, its
    ``lse`` (B, H, Sq) f32 and the output's gradient ``do``, in the
    operands' dtypes. CPU tensors take ``attention_bwd_ref``; CUDA
    tensors launch the backward kernel ``plan`` picks, or raise.

    ``flash_attention_bwd.launches`` counts the launches of this process
    (each runs the kernel's passes: D, dK/dV and dQ) and
    ``flash_attention_bwd.variants`` counts them by variant."""
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, do, lse, **kw)
    return _backward(q, k, v, o, do, lse, **kw)


def _backward(q, k, v, o, do, lse, *, causal, window, scale, q_offset, force_fma=False):
    """The backward kernel on CUDA tensors. ``force_fma`` launches the
    ``fma`` kernel whatever ``plan`` says (it takes every layout), so
    that a measurement can time both variants on the same inputs."""
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    _check_qkv(q, k, v, "flash_attention_bwd")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype}, do "
                         f"{tuple(do.shape)}, q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device}; want ({b}, {h}, {sq}) float32")
    do = do.to(q.dtype)
    ins = [t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, o, do)]
    variant = plan(q.dtype, d, tuple(t.stride() for t in ins), aligned16(*ins))
    if force_fma:
        variant = "fma"
    lse = lse.contiguous()
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v)]
    if b and sq and h:
        if skv == 0:
            raise ValueError("flash_attention_bwd: empty key sequence")
        dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        if q.device.type == "meta":
            charge("flash_attention_bwd", variant, bwd_work(b, sq, skv, h, kvh, d,
                                                            q.element_size(), causal, window,
                                                            q_offset))
            return tuple(outs)
        strides = (ctypes.c_longlong * 24)(*[x for t in ins + outs for x in t.stride()[:3]])
        lib = _bwd_lib()
        err = lib.flash_attention_bwd_launch(
            *(t.data_ptr() for t in ins), lse.data_ptr(), dsum.data_ptr(),
            *(t.data_ptr() for t in outs), b, h, kvh, sq, skv, d, strides,
            scale if scale is not None else 1.0 / math.sqrt(d), int(bool(causal)),
            _NO_WINDOW if window is None else int(window), int(q_offset), _DTYPES[q.dtype],
            _CODES[variant], torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.check(lib, err, f"flash_attention_bwd ({variant})")
        flash_attention_bwd.launches += 1
        flash_attention_bwd.variants[variant] += 1
    else:
        for t in outs:
            t.zero_()
    return tuple(outs)


flash_attention_bwd.launches = 0
flash_attention_bwd.variants = dict.fromkeys(VARIANTS, 0)


flash_attention.launches = 0
flash_attention.variants = dict.fromkeys(VARIANTS, 0)


def split_plan(b: int, kvh: int, s: int) -> int:
    """The number of slices a decode call splits each row's visible slots
    into: enough blocks to fill the card twice over, no slice shorter than
    a tile at the cache's full length, at most 64. From shapes alone, so
    that lengths on the device never reach the host."""
    want = -(-_DECODE_BLOCKS // max(1, b * kvh))
    return max(1, min(want, -(-s // _DECODE_TILE), 64))


def visible_slots(s: int, lengths, window) -> list[int]:
    """Each row's visible slots: ``lengths`` (one int a row) clipped to the
    cache's ``s`` slots and to the trailing ``window`` of them."""
    out = []
    for n in lengths:
        hi, lo = min(n, s), max(0, n - window) if window is not None else 0
        out.append(max(0, hi - lo))
    return out


def decode_work(b, s, h, kvh, d, q_es, kv_es, lengths, window=None, with_lse=False) -> Work:
    """One decode call's work: q read once, each row's visible K and V
    rows read once (``visible_slots`` of ``lengths``, one int a row), o
    (f32 with ``with_lse``, else q's dtype) and the f32 lse written once;
    4 D operations per visible slot and query head. The plain version's
    FLOPs are its two einsums over every slot, 4 B H S D."""
    vis = sum(visible_slots(s, lengths, window))
    o_es = 4 if with_lse else q_es
    n_bytes = b * h * d * q_es + 2 * kvh * d * kv_es * vis + b * h * d * o_es + 4 * b * h * with_lse
    full = b * h * s * d
    return Work(float(n_bytes), 4.0 * d * h * vis, einsum_flops((d, full), (s, full)))


def _lengths(length, b, device):
    """(length as an int, or 0; the per-batch tensor or None; its element
    stride) of a kernel call. A tensor must already be on the kernel's
    device: nothing is copied to it."""
    if isinstance(length, torch.Tensor):
        if length.device != device:
            raise ValueError(f"decode_attention: lengths on {length.device}, the cache on "
                             f"{device}; pass them on {device} or as an int")
        if length.dtype not in _LENGTH_DTYPES or length.numel() not in (1, b):
            raise ValueError(f"decode_attention: lengths {tuple(length.shape)} {length.dtype}; "
                             f"want 1 or {b} int32/int64")
        flat = length.reshape(-1)
        return 0, flat, flat.stride(0) if flat.numel() == b and b > 1 else 0
    if isinstance(length, numbers.Integral):
        return int(length), None, 0
    raise TypeError(f"decode_attention: length {type(length).__name__}; an int or a tensor")


def decode_attention(q, k_cache, v_cache, *, length, window: int | None = None,
                     scale: float | None = None, return_lse: bool = False):
    """One decode step: q (B, 1, H, D) attends to the first ``length``
    cache slots (B, S, KVH, D) (and at most the trailing ``window`` of
    them, the newest slot ``length - 1`` included). ``length`` is an int
    or a per-batch tensor. A row with no valid slot returns exact zeros.

    ``return_lse`` returns ``(o, lse)`` instead: o in f32 (not yet cast
    to q's dtype) and each row's log-sum-exp of its scaled scores, (B, 1,
    H) f32, -inf for a row with no valid slot, so that the partial results
    of a sequence-sharded cache can be merged (``models/layers.py``)."""
    kw = dict(length=length, window=window, scale=scale, return_lse=return_lse)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, **kw)
    return _decode(q, k_cache, v_cache, **kw)


def _decode(q, k_cache, v_cache, *, length, window, scale, return_lse):
    """The decode kernel on CUDA tensors (or its charge on meta ones)."""
    b, sq, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    dev = q.device
    if not kernel_device(q) or k_cache.device != dev or v_cache.device != dev:
        raise ValueError(f"decode_attention: tensors on {dev}, {k_cache.device}, "
                         f"{v_cache.device}")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"decode_attention kernel: q f32 or bf16, k and v one of them; got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if (sq != 1 or v_cache.shape != k_cache.shape or k_cache.shape[0] != b
            or k_cache.shape[3] != d or h % kvh):
        raise ValueError(f"decode_attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if d not in HEAD_DIMS or h // kvh > _DECODE_MAX_GROUP:
        raise ValueError(f"decode_attention kernel: head dim {d} (one of {HEAD_DIMS}), "
                         f"group {h // max(kvh, 1)} (at most {_DECODE_MAX_GROUP})")
    vec = 16 // k_cache.element_size()
    if any(c.stride(3) != 1 or not aligned16(c) or any(x % vec for x in c.stride()[:3])
           for c in (k_cache, v_cache)):
        raise ValueError(f"decode_attention kernel: K and V rows must start on 16 bytes with "
                         f"a unit head-dim stride; got strides {k_cache.stride()}, "
                         f"{v_cache.stride()}")
    n, lengths, lstride = _lengths(length, b, dev)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty((b, 1, h, d), dtype=torch.float32 if return_lse else q.dtype, device=dev)
    lse = torch.empty((b, 1, h), dtype=torch.float32, device=dev) if return_lse else None
    nsplit = split_plan(b, kvh, s)
    part = (torch.empty((nsplit, b, h, d + 2), dtype=torch.float32, device=dev)
            if nsplit > 1 and b * h else None)
    if b * h:
        if dev.type == "meta":
            rows = [n] * b if lengths is None else [s] * b  # a meta length has no value: all
            charge("decode_attention", "split", decode_work(
                b, s, h, kvh, d, q.element_size(), k_cache.element_size(), rows, window,
                return_lse))
        else:
            lib = _decode_lib()
            err = lib.decode_attention_launch(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), None if part is None else part.data_ptr(),
                b, h, kvh, s, d, q.stride(0), q.stride(2), q.stride(3),
                *k_cache.stride()[:3], *v_cache.stride()[:3], n,
                None if lengths is None else lengths.data_ptr(),
                _LENGTH_DTYPES[lengths.dtype] if lengths is not None else 0, lstride,
                _NO_WINDOW if window is None else int(window), scale,
                int(q.dtype == torch.bfloat16), int(k_cache.dtype == torch.bfloat16),
                int(o.dtype == torch.float32), nsplit, torch.cuda.current_stream(dev).cuda_stream)
            _build.check(lib, err, "decode_attention")
            decode_attention.launches += 1
            decode_attention.variants["split"] += 1
    return (o, lse) if return_lse else o


decode_attention.launches = 0
decode_attention.variants = {"split": 0}
