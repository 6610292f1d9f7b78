"""Public op: the sLSTM recurrence, dispatched by the device of its inputs.

``slstm_scan(z_in, i_in, f_in, o_in, r, c0, n0, h0)`` walks xLSTM's
scalar-memory recurrence over the sequence (``ref.py`` states it) and
returns ``(ys, c, n, h)``: every step's h (B, S, E) and the final state,
all f32. z_in and o_in are (B, S, E), i_in and f_in (B, S, H), r (H, d,
d) with d = E / H, and the initial state c0, h0 (B, E), n0 (B, H):
zeros for prefill and training, the cache for decode.

For CPU tensors the op runs its plain version, ``slstm_scan_ref``. For
CUDA tensors it launches a hand-written kernel of ``csrc/slstm.cu``
(built on first use; one block per (batch, head), f32 on the CUDA
cores), or raises: nothing falls back. ``plan(d)`` picks the variant:
``reg`` (r[h] held in registers for the whole walk, one block barrier a
step, each step's inputs copied into a shared-memory ring ahead) where
its registers fit, d a multiple of 16 up to ``REG_MAX_D``, and ``fma``
(r[h] in shared memory) for every other d. ``slstm_scan.launches``
counts its launches and ``slstm_scan.variants`` counts them by variant.

Training: when an input requires grad, the op runs through an autograd
``Function``. Its forward also keeps each step's c, n and z (on the card
the kernel stores them: 2 B S E + B S H floats, 25.2 MB per sLSTM layer
at xlstm-125m's 8 x 512); its backward calls ``slstm_scan_bwd``, which
launches ``csrc/slstm_bwd.cu`` on the card (``slstm_scan_bwd.launches``,
``.variants``; the same ``plan``) and runs ``slstm_scan_bwd_ref`` on the
CPU, and forms the gradient of r outside the kernel with one
``torch.matmul`` per head (``slstm_dr``). ``_forward`` and ``_backward``
take a private ``force_fma`` that launches ``fma`` whatever ``plan``
says, so that a measurement can time both variants on the same inputs.
Meta tensors (the dry-run's accounting, ``kernels/_meta.py``) take the
CUDA branch up to the launch: planned and charged ``work``
(``bwd_work``) with their variant, counted by the accounting and not in
the launch counters.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._meta import Work, aligned16, charge, kernel_device
from .ref import slstm_dr, slstm_scan_bwd_ref, slstm_scan_ref

__all__ = ["REG_MAX_D", "VARIANTS", "bwd_work", "part_floats", "plan", "slstm_scan",
           "slstm_scan_bwd", "work"]

VARIANTS = ("reg", "fma")
_CODES = {"fma": 0, "reg": 1}
REG_MAX_D = 192  # the widest d whose share of r fits a thread's registers (csrc/slstm_reg.cuh)
_LIB = None
_BWD_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("slstm")
        lib.slstm_scan_launch.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.slstm_scan_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load("slstm_bwd")
        lib.slstm_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.slstm_scan_bwd_launch.restype = ctypes.c_int
        lib.slstm_bwd_part_floats.argtypes = [ctypes.c_int]
        lib.slstm_bwd_part_floats.restype = ctypes.c_int
        _BWD_LIB = lib
    return _BWD_LIB


def _ptr(t):
    return None if t is None else t.data_ptr()


def plan(d: int) -> str:
    """The variant for head width ``d``: ``reg`` where r's share of a
    thread fits in registers (d a multiple of 16, 16 <= d <= REG_MAX_D),
    else ``fma`` (any d up to 1024)."""
    return "reg" if d % 16 == 0 and 16 <= d <= REG_MAX_D else "fma"


def work(b, s, h, d, store=False) -> Work:
    """One forward launch's work. Bytes: z_in, o_in, i_in, f_in, r and
    the initial state read once; ys and the final state written once (with
    ``store`` each step's c, n, z too). Operations: 2 d^2 for the matvec
    and 8 per element for the gates, per (b, h, step). FLOPs: the plain
    version's matvec, 2 d^2 per (b, h, step)."""
    e = h * d
    n_bytes = 4 * (3 * b * s * e + 2 * b * s * h + h * d * d + 2 * (2 * b * e + b * h)
                   + ((2 * b * s * e + b * s * h) if store else 0))
    return Work(n_bytes, float(b * s * h * (2 * d * d + 8 * d)), 2.0 * b * s * h * d * d)


def bwd_work(b, s, h, d) -> Work:
    """One backward launch's work. Bytes: i_in, f_in, n_all, o_in, c_all,
    z_all, dys, r and the initial c, n read once; dz_in, do_in, di_in,
    df_in and the initial state's gradients written once. Operations: 2
    d^2 for the transposed matvec and 20 per element for the gates'
    gradients. FLOPs: the plain version's transposed matvec, 2 d^2 per
    (b, h, step)."""
    e = h * d
    n_bytes = 4 * (3 * b * s * h + 4 * b * s * e + h * d * d + b * e + b * h
                   + 2 * b * s * e + 2 * b * s * h + 2 * b * e + b * h)
    return Work(n_bytes, float(b * s * h * (2 * d * d + 20 * d)), 2.0 * b * s * h * d * d)


def part_floats(d: int) -> int:
    """``slstm_bwd_part_floats`` of ``csrc/slstm_bwd.cu`` (CPT 2, KS 4): the
    reg backward's scratch per (b, h, step), for meta tensors (chip_smoke.py
    holds it to the library's)."""
    return 3 * (d // 2 * 4 // 32)


def _aligned(t):
    """``t``, or a copy of it whose base is 16-byte aligned (the reg
    variants copy rows of it with 16-byte cp.async)."""
    return t if aligned16(t) else t.clone()


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
    if not kernel_device(ts[0]) or any(t.device != dev for t in ts if t is not None):
        raise ValueError(f"{what}: tensors on {[None if t is None else t.device for t in ts]}")
    return [None if t is None else t.float().contiguous() for t in ts]


def _forward(z_in, i_in, f_in, o_in, r, c0, n0, h0, store=False, force_fma=False):
    """The forward kernel on CUDA tensors: ``(ys, c, n, h, saved)``,
    saved ``(c_all, n_all, z_all)`` or None unless ``store``.
    ``force_fma`` launches ``fma`` whatever ``plan`` says."""
    b, s, h, d = _shapes(z_in, i_in, r)
    z_in, i_in, f_in, o_in, r, c0, n0, h0 = _on_card("slstm_scan", z_in, i_in, f_in, o_in, r,
                                                     c0, n0, h0)
    variant = "fma" if force_fma else plan(d)
    if variant == "reg":
        z_in, o_in = _aligned(z_in), _aligned(o_in)
    e = h * d
    dev = z_in.device
    ys = torch.empty((b, s, e), dtype=torch.float32, device=dev)
    saved = ((torch.empty((b, s, e), dtype=torch.float32, device=dev),
              torch.empty((b, s, h), dtype=torch.float32, device=dev),
              torch.empty((b, s, e), dtype=torch.float32, device=dev)) if store else None)
    if not (b and s and h and d):  # nothing to walk: the state as it was
        return ys, c0.clone(), n0.clone(), h0.clone(), saved
    c, n, hl = torch.empty_like(c0), torch.empty_like(n0), torch.empty_like(h0)
    if dev.type == "meta":
        charge("slstm_scan", variant, work(b, s, h, d, store))
        return ys, c, n, hl, saved
    lib = _lib()
    err = lib.slstm_scan_launch(
        _ptr(z_in), _ptr(i_in), _ptr(f_in), _ptr(o_in), _ptr(r), _ptr(c0), _ptr(n0), _ptr(h0),
        _ptr(ys), _ptr(c), _ptr(n), _ptr(hl), *(_ptr(t) for t in (saved or (None,) * 3)),
        b, s, h, d, _CODES[variant], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, f"slstm_scan ({variant})")
    slstm_scan.launches += 1
    slstm_scan.variants[variant] += 1
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
    ``slstm_scan_bwd_ref``; CUDA tensors launch the backward kernel of
    ``plan``'s variant, or raise. ``slstm_scan_bwd.launches`` counts the
    launches of this process, ``.variants`` by variant."""
    if dys.device.type == "cpu":
        return slstm_scan_bwd_ref(i_in, f_in, o_in, r, c0, n0, saved, dys, dc, dn, dh)
    return _backward(i_in, f_in, o_in, r, c0, n0, saved, dys, dc, dn, dh)


def _backward(i_in, f_in, o_in, r, c0, n0, saved, dys, dc=None, dn=None, dh=None,
              force_fma=False):
    """The backward kernel on CUDA tensors; ``force_fma`` launches
    ``fma`` whatever ``plan`` says. The reg variant stores each step's
    per-warp sums in a scratch of B H S ``slstm_bwd_part_floats(d)``
    floats and finishes di_in, df_in and dn from it after its walk."""
    b, s, e = dys.shape
    _, _, h, d = _shapes(dys, i_in, r)
    c_all, n_all, z_all = saved
    if (tuple(c_all.shape) != (b, s, e) or tuple(n_all.shape) != (b, s, h)
            or z_all.shape != c_all.shape):
        raise ValueError(f"slstm_scan_bwd: saved {[tuple(t.shape) for t in saved]}")
    (i_in, f_in, o_in, r, c0, n0, c_all, n_all, z_all, dys, dc, dn, dh) = _on_card(
        "slstm_scan_bwd", i_in, f_in, o_in, r, c0, n0, c_all, n_all, z_all, dys, dc, dn, dh)
    variant = "fma" if force_fma else plan(d)
    dz_in, do_in = torch.empty_like(dys), torch.empty_like(dys)
    di_in, df_in = torch.empty_like(i_in), torch.empty_like(f_in)
    dc0, dn0, dh0 = torch.empty_like(c0), torch.empty_like(n0), torch.empty_like(c0)
    meta = dys.device.type == "meta"
    lib = None if meta else _bwd_lib()
    part = None
    if variant == "reg":
        c_all, z_all, o_in, dys = (_aligned(t) for t in (c_all, z_all, o_in, dys))
        part = torch.empty(b * h * s * (part_floats(d) if meta else lib.slstm_bwd_part_floats(d)),
                           dtype=torch.float32, device=dys.device)
    if meta:
        charge("slstm_scan_bwd", variant, bwd_work(b, s, h, d))
        return dz_in, di_in, df_in, do_in, dc0, dn0, dh0
    err = lib.slstm_scan_bwd_launch(
        *(_ptr(t) for t in (i_in, f_in, o_in, r, c0, n0, c_all, n_all, z_all, dys, dc, dn, dh,
                            dz_in, di_in, df_in, do_in, dc0, dn0, dh0, part)),
        b, s, h, d, _CODES[variant], torch.cuda.current_stream(dys.device).cuda_stream)
    _build.check(lib, err, f"slstm_scan_bwd ({variant})")
    slstm_scan_bwd.launches += 1
    slstm_scan_bwd.variants[variant] += 1
    return dz_in, di_in, df_in, do_in, dc0, dn0, dh0


slstm_scan_bwd.launches = 0
slstm_scan_bwd.variants = dict.fromkeys(VARIANTS, 0)
