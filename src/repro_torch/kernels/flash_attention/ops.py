"""Public attention ops used by the model.

``flash_attention``: prefill attention over whole sequences. For CPU
tensors it runs the plain ``attention_ref``; for CUDA tensors it
launches the hand-written kernel of ``csrc/flash_attention.cu`` (built
on first use), or raises. ``flash_attention.launches`` counts the
kernel launches of this process.

``decode_attention``: one query token against a KV cache. It is not a
Pallas kernel in the JAX package either (a batched GEMV that XLA
compiles); here it stays plain PyTorch on every device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import attention_ref

__all__ = ["flash_attention", "decode_attention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 80, 128, 256)
_NO_WINDOW = 2**62  # wider than any sequence: no window mask
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
               ctypes.c_int, ctypes.c_void_p]
        )
        lib.flash_attention_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None, q_offset: int = 0):
    """q (B, Sq, H, D); k, v (B, Skv, KVH, D) -> (B, Sq, H, D).

    ``window`` and ``q_offset`` are Python ints (the port runs its layers
    in a Python loop, so a layer's window is never a traced value).
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                             q_offset=q_offset)
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: tensors on {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes f32 or bf16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; head dim must be one of {_HEAD_DIMS}")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs a unit stride on the head dim")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b and sq and h:
        if skv == 0:
            raise ValueError("flash_attention: empty key sequence")
        lib = _lib()
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, kvh, sq, skv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            scale, int(bool(causal)), _NO_WINDOW if window is None else int(window),
            int(q_offset), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.check(lib, err, "flash_attention")
        flash_attention.launches += 1
    return o


flash_attention.launches = 0


def decode_attention(q, k_cache, v_cache, *, length, window: int | None = None,
                     scale: float | None = None):
    """One decode step: q (B, 1, H, D) attends to the first ``length``
    cache slots (and at most the trailing ``window`` of them, the newest
    slot ``length - 1`` included). ``length`` is an int or a per-batch
    tensor. A row with no valid slot returns exact zeros."""
    b, _, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    qf = (q.float() * scale).to(q.dtype).reshape(b, kvh, g, d)
    kc = k_cache.transpose(1, 2)  # (B, KVH, S, D)
    vc = v_cache.transpose(1, 2)
    logits = torch.einsum("bkgd,bksd->bkgs", qf.float(), kc.float())

    pos = torch.arange(s, device=q.device)[None, :]
    # an int length stays a Python scalar: no host-to-device copy per call
    lengths = length if isinstance(length, int) else (
        torch.as_tensor(length, device=q.device).reshape(-1, 1))
    valid = pos < lengths
    if window is not None:
        valid = valid & (pos >= lengths - window)
    vmask = valid.expand(b, s)[:, None, None, :]
    logits = torch.where(vmask, logits, torch.finfo(torch.float32).min * 0.7)
    m = logits.amax(dim=-1, keepdim=True)
    # Masked slots are zeroed explicitly, so a row with no valid slot
    # (length 0, or a window that excludes everything) is exact zeros.
    p = torch.where(vmask, torch.exp(logits - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom > 0.0, denom, 1.0)
    o = torch.einsum("bkgs,bksd->bkgd", p.to(v_cache.dtype).float(), vc.float())
    return o.reshape(b, 1, h, d).to(q.dtype)
