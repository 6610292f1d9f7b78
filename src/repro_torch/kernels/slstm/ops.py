"""Public op: the sLSTM recurrence, dispatched by the device of its inputs.

``slstm_scan(z_in, i_in, f_in, o_in, r, c0, n0, h0)`` walks xLSTM's
scalar-memory recurrence over the sequence (``ref.py`` states it) and
returns ``(ys, c, n, h)``: every step's h (B, S, E) and the final state,
all f32. z_in and o_in are (B, S, E), i_in and f_in (B, S, H), r (H, d,
d) with d = E / H, and the initial state c0, h0 (B, E), n0 (B, H):
zeros for prefill and training, the cache for decode.

For CPU tensors the op runs its plain version, ``slstm_scan_ref``. For
CUDA tensors it launches the hand-written kernel of ``csrc/slstm.cu``
(built on first use; one block per (batch, head) with r[h] in shared
memory, f32 on the CUDA cores), or raises: nothing falls back.
``slstm_scan.launches`` counts its launches and ``slstm_scan.variants``
counts them by variant (one: ``fma``).

Training: when an input requires grad, the op runs through an autograd
``Function``. Its forward also keeps each step's c, n and z (on the card
the kernel stores them: 2 B S E + B S H floats, 25.2 MB per sLSTM layer
at xlstm-125m's 8 x 512); its backward calls ``slstm_scan_bwd``, which
launches ``csrc/slstm_bwd.cu`` on the card (``slstm_scan_bwd.launches``,
``.variants``) and runs ``slstm_scan_bwd_ref`` on the CPU, and forms
the gradient of r outside the kernel with one ``torch.matmul`` per head
(``slstm_dr``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import slstm_dr, slstm_scan_bwd_ref, slstm_scan_ref

__all__ = ["VARIANTS", "slstm_scan", "slstm_scan_bwd"]

VARIANTS = ("fma",)
_LIB = None
_BWD_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("slstm")
        lib.slstm_scan_launch.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.slstm_scan_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load("slstm_bwd")
        lib.slstm_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.slstm_scan_bwd_launch.restype = ctypes.c_int
        _BWD_LIB = lib
    return _BWD_LIB


def _ptr(t):
    return None if t is None else t.data_ptr()


def _shapes(z_in, i_in, r):
    b, s, e = z_in.shape
    h = r.shape[0]
    if tuple(i_in.shape) != (b, s, h) or e != h * r.shape[1] or r.shape[1] != r.shape[2]:
        raise ValueError(f"slstm_scan: shapes z_in {tuple(z_in.shape)}, i_in "
                         f"{tuple(i_in.shape)}, r {tuple(r.shape)}")
    return b, s, h, r.shape[1]


def _on_card(what, *ts):
    """f32, contiguous copies (or the tensors themselves) on one card."""
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts if t is not None):
        raise ValueError(f"{what}: tensors on {[None if t is None else t.device for t in ts]}")
    return [None if t is None else t.float().contiguous() for t in ts]


def _forward(z_in, i_in, f_in, o_in, r, c0, n0, h0, store=False):
    """The forward kernel on CUDA tensors: ``(ys, c, n, h, saved)``,
    saved ``(c_all, n_all, z_all)`` or None unless ``store``."""
    b, s, h, d = _shapes(z_in, i_in, r)
    z_in, i_in, f_in, o_in, r, c0, n0, h0 = _on_card("slstm_scan", z_in, i_in, f_in, o_in, r,
                                                     c0, n0, h0)
    e = h * d
    dev = z_in.device
    ys = torch.empty((b, s, e), dtype=torch.float32, device=dev)
    saved = ((torch.empty((b, s, e), dtype=torch.float32, device=dev),
              torch.empty((b, s, h), dtype=torch.float32, device=dev),
              torch.empty((b, s, e), dtype=torch.float32, device=dev)) if store else None)
    if not (b and s and h and d):  # nothing to walk: the state as it was
        return ys, c0.clone(), n0.clone(), h0.clone(), saved
    c, n, hl = torch.empty_like(c0), torch.empty_like(n0), torch.empty_like(h0)
    lib = _lib()
    err = lib.slstm_scan_launch(
        _ptr(z_in), _ptr(i_in), _ptr(f_in), _ptr(o_in), _ptr(r), _ptr(c0), _ptr(n0), _ptr(h0),
        _ptr(ys), _ptr(c), _ptr(n), _ptr(hl), *(_ptr(t) for t in (saved or (None,) * 3)),
        b, s, h, d, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "slstm_scan")
    slstm_scan.launches += 1
    slstm_scan.variants["fma"] += 1
    return ys, c, n, hl, saved


class _SlstmScan(torch.autograd.Function):
    """The recurrence with its closed-form backward: the forward keeps
    each step's c, n and z; the backward is ``slstm_scan_bwd`` and, for
    r, ``slstm_dr``."""

    @staticmethod
    def forward(ctx, z_in, i_in, f_in, o_in, r, c0, n0, h0):
        if z_in.device.type == "cpu":
            (ys, c, n, hl), saved = slstm_scan_ref(z_in, i_in, f_in, o_in, r, c0, n0, h0,
                                                   store=True)
        else:
            ys, c, n, hl, saved = _forward(z_in, i_in, f_in, o_in, r, c0, n0, h0, store=True)
        ctx.save_for_backward(i_in, f_in, o_in, r, c0, n0, h0, ys, *saved)
        ctx.set_materialize_grads(False)
        return ys, c, n, hl

    @staticmethod
    def backward(ctx, dys, dc, dn, dh):
        i_in, f_in, o_in, r, c0, n0, h0, ys, *saved = ctx.saved_tensors
        if dys is None:
            dys = torch.zeros_like(ys)
        dz_in, di_in, df_in, do_in, dc0, dn0, dh0 = slstm_scan_bwd(
            i_in, f_in, o_in, r, c0, n0, saved, dys, dc, dn, dh)
        dr = slstm_dr(h0.float(), ys, dz_in, r.shape[0]) if ctx.needs_input_grad[4] else None
        return dz_in, di_in, df_in, do_in, dr, dc0, dn0, dh0


def slstm_scan(z_in, i_in, f_in, o_in, r, c0, n0, h0):
    """The sLSTM recurrence: ``(ys (B, S, E), c (B, E), n (B, H), h (B,
    E))``, f32. Differentiable when an input requires grad."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (z_in, i_in, f_in, o_in, r, c0, n0, h0)):
        return _SlstmScan.apply(z_in, i_in, f_in, o_in, r, c0, n0, h0)
    if z_in.device.type == "cpu":
        return slstm_scan_ref(z_in, i_in, f_in, o_in, r, c0, n0, h0)
    return _forward(z_in, i_in, f_in, o_in, r, c0, n0, h0)[:4]


slstm_scan.launches = 0
slstm_scan.variants = dict.fromkeys(VARIANTS, 0)


def slstm_scan_bwd(i_in, f_in, o_in, r, c0, n0, saved, dys, dc=None, dn=None, dh=None):
    """``(dz_in, di_in, df_in, do_in, dc0, dn0, dh0)`` of ``slstm_scan``
    given the forward's ``saved = (c_all, n_all, z_all)``, the gradient
    of ys (``dys``) and those of the final state (``dc``, ``dn``, ``dh``;
    None where the caller dropped it), all f32. CPU tensors take
    ``slstm_scan_bwd_ref``; CUDA tensors launch the backward kernel, or
    raise. ``slstm_scan_bwd.launches`` counts the launches of this
    process."""
    if dys.device.type == "cpu":
        return slstm_scan_bwd_ref(i_in, f_in, o_in, r, c0, n0, saved, dys, dc, dn, dh)
    b, s, e = dys.shape
    _, _, h, d = _shapes(dys, i_in, r)
    c_all, n_all, z_all = saved
    if (tuple(c_all.shape) != (b, s, e) or tuple(n_all.shape) != (b, s, h)
            or z_all.shape != c_all.shape):
        raise ValueError(f"slstm_scan_bwd: saved {[tuple(t.shape) for t in saved]}")
    (i_in, f_in, o_in, r, c0, n0, c_all, n_all, z_all, dys, dc, dn, dh) = _on_card(
        "slstm_scan_bwd", i_in, f_in, o_in, r, c0, n0, c_all, n_all, z_all, dys, dc, dn, dh)
    dz_in, do_in = torch.empty_like(dys), torch.empty_like(dys)
    di_in, df_in = torch.empty_like(i_in), torch.empty_like(f_in)
    dc0, dn0, dh0 = torch.empty_like(c0), torch.empty_like(n0), torch.empty_like(c0)
    lib = _bwd_lib()
    err = lib.slstm_scan_bwd_launch(
        *(_ptr(t) for t in (i_in, f_in, o_in, r, c0, n0, c_all, n_all, z_all, dys, dc, dn, dh,
                            dz_in, di_in, df_in, do_in, dc0, dn0, dh0)),
        b, s, h, d, torch.cuda.current_stream(dys.device).cuda_stream)
    _build.check(lib, err, "slstm_scan_bwd")
    slstm_scan_bwd.launches += 1
    slstm_scan_bwd.variants["fma"] += 1
    return dz_in, di_in, df_in, do_in, dc0, dn0, dh0


slstm_scan_bwd.launches = 0
slstm_scan_bwd.variants = dict.fromkeys(VARIANTS, 0)
