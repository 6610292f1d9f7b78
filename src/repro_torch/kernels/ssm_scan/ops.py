"""Public op: the chunked SSD scan, dispatched by the device of its inputs.

``ssm_scan(u, ld, B, C)`` in the model-facing layout u (Bt, S, H, P),
ld (Bt, S, H), B, C (Bt, S, H, N); returns y (Bt, S, H, P) in u's dtype
and the final state (Bt, H, N, P) in f32.

For CPU tensors the op runs its plain version, ``ssm_scan_chunked``, a
twin of the JAX package's ``ssm_scan_chunked_jnp``: the same chunked
math (decay mask formed before the exp), with a ragged S padded by
identity steps (ld = 0, u = 0, B = 0 leave the state as it was). For
CUDA tensors it launches one of the hand-written kernels of
``csrc/ssm_scan.cu`` (built on first use), or raises: nothing falls
back. The kernels read every input through its strides, so B and C
broadcast over the heads (an ``expand``, stride 0) are never copied,
and mask a ragged S and a ragged P tile themselves. ``plan`` picks the
kernel before the launch, from dtype, state dim, chunk and layout alone:

- ``mma``: bf16 u, B, C with a unit inner stride, their other strides
  multiples of 8 elements (0 included) and 16-byte aligned bases, and P
  a multiple of 8: the tensor-core kernel. zamba2's prefill runs it.
- ``fma``: f32 operands, and bf16 layouts ``mma`` cannot take: the f32
  CUDA-core kernel.

``ssm_scan.launches`` counts the kernel launches of this process and
``ssm_scan.variants`` counts them by variant.

B and C come as (Bt, S, H, N), or as (Bt, S, 1, N): one B and C for
every head (Mamba2's layout), which the wrapper expands over the heads
as a view (stride 0) before the kernel or the plain version reads it.

Training: when an input requires grad, ``ssm_scan`` runs through an
autograd ``Function``. On the card its forward asks the kernel for the
f32 state entering each chunk as well (``states``, (Bt, H, n_chunks, N,
P)) and its backward calls ``ssm_scan_bwd``, which launches the
hand-written backward of ``csrc/ssm_scan_bwd.cu`` (one variant, ``fma``:
f32 on the CUDA cores; ``ssm_scan_bwd.launches`` and ``.variants``
count it). On CPU tensors the Function's forward and backward are the
plain ``ssm_scan_chunked`` and ``ssm_scan_bwd_ref``. dB and dC are
formed per head in f32 and, for a head dim of 1, summed over the heads
in f32 before the cast to B's dtype. Without grad (serving, calibration)
nothing changes: no states are stored.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import _chunks, ssm_scan_bwd_ref

__all__ = ["CHUNK", "CHUNKS", "STATE_DIMS", "VARIANTS", "plan", "ssm_scan", "ssm_scan_bwd",
           "ssm_scan_chunked"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (32, 64)  # chunk lengths the kernel is built for
CHUNK = 32  # the default: the faster at zamba2's prefill on an H100, in both variants (PERF.md)
STATE_DIMS = (16, 32, 64, 96)  # N the kernels are built for (reduced, calibration, zamba2,
# mLSTM); P is any
VARIANTS = ("mma", "fma")
_CODES = {"fma": 0, "mma": 1}
_LIB = None
_BWD_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("ssm_scan")
        lib.ssm_scan_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 19
            + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.ssm_scan_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load("ssm_scan_bwd")
        lib.ssm_scan_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.ssm_scan_bwd_launch.restype = ctypes.c_int
        _BWD_LIB = lib
    return _BWD_LIB


def _check(dtype: torch.dtype, n: int, chunk: int):
    """Raise for what no kernel takes: a dtype other than f32 and bf16, N
    not in ``STATE_DIMS`` or a chunk not in ``CHUNKS``."""
    if dtype not in _DTYPES:
        raise TypeError(f"ssm_scan kernel takes u, B, C in f32 or bf16; got {dtype}")
    if n not in STATE_DIMS or chunk not in CHUNKS:
        raise ValueError(f"ssm_scan kernel: state dim N={n} must be one of {STATE_DIMS} "
                         f"and chunk={chunk} one of {CHUNKS}")


def plan(dtype: torch.dtype, n: int, chunk: int, p: int, strides, aligned: bool) -> str:
    """The kernel variant for one call. ``strides`` holds the element
    strides of u (b, s, h, p), B and C (b, s, h, n); ``aligned`` says
    that their three bases are 16-byte aligned. Raises for what neither
    variant takes: a dtype other than f32 and bf16, N not in
    ``STATE_DIMS`` or a chunk not in ``CHUNKS``."""
    _check(dtype, n, chunk)
    if (dtype == torch.bfloat16 and aligned and p % 8 == 0
            and all(st[3] == 1 and all(x % 8 == 0 for x in st[:3]) for st in strides)):
        return "mma"
    return "fma"


def ssm_scan_chunked(u, ld, B, C, chunk: int = CHUNK):
    """Chunked SSD in plain PyTorch, vectorized over (batch, head); the
    same math as the kernel and as the JAX package's chunked twin."""
    bt, s, h, p = u.shape
    n = B.shape[-1]
    if s == 0:
        return u.clone(), torch.zeros((bt, h, n, p), dtype=torch.float32, device=u.device)
    k = _chunks(u, ld, B, C, chunk)
    # intra-chunk, batched over (bt, nc, h); the states come from the loop
    # over chunks in _chunks, which carries only the state
    cb = torch.einsum("bcihn,bcjhn->bcijh", k.C, k.B)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb * k.lmat, k.u)
    y_inter = torch.einsum("bcihn,bchnp->bcihp", k.C, k.states) * torch.exp(k.la)[..., None]
    y = (y_intra + y_inter).reshape(bt, -1, h, p)[:, :s]
    return y.to(u.dtype), k.final


def _heads(t, h):
    """B or C over the heads: a head dim of 1 expanded to ``h`` (a view)."""
    return t.expand(-1, -1, h, -1) if t.shape[2] == 1 and h != 1 else t


def _check_inputs(u, ld, B, C, what):
    """Device, shape and dtype checks of a kernel call."""
    bt, s, h, p = u.shape
    n = B.shape[-1]
    if u.device.type != "cuda" or any(t.device != u.device for t in (ld, B, C)):
        raise ValueError(f"{what}: tensors on {u.device}, {ld.device}, {B.device}, {C.device}")
    if (tuple(ld.shape) != (bt, s, h) or tuple(B.shape) != (bt, s, h, n)
            or C.shape != B.shape):
        raise ValueError(f"{what}: shapes u {tuple(u.shape)}, ld {tuple(ld.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    if B.dtype != u.dtype or C.dtype != u.dtype:
        raise TypeError(f"{what} kernel takes u, B, C of one dtype, f32 or bf16; got "
                        f"{u.dtype}, {B.dtype}, {C.dtype}")
    if bt > 65535 or h > 65535:
        raise ValueError(f"{what} kernel: batch {bt} and heads {h} must be <= 65535")


def _forward(u, ld, B, C, chunk, with_states=False):
    """The forward kernel on CUDA tensors (B, C with H heads): ``(y,
    state, states)``, states (Bt, H, n_chunks, N, P) f32 the state
    entering each chunk, None unless ``with_states``."""
    bt, s, h, p = u.shape
    n = B.shape[-1]
    _check_inputs(u, ld, B, C, "ssm_scan")
    variant = plan(u.dtype, n, chunk, p, (u.stride(), B.stride(), C.stride()),
                   (u.data_ptr() | B.data_ptr() | C.data_ptr()) % 16 == 0)
    ld = ld.float()
    y = torch.empty((bt, s, h, p), dtype=u.dtype, device=u.device)
    launch = bool(bt and s and h and p)
    # both kernels write every entry of the state: no fill kernel before them
    state = (torch.empty if launch else torch.zeros)((bt, h, n, p), dtype=torch.float32,
                                                     device=u.device)
    states = (torch.empty((bt, h, -(-s // chunk), n, p), dtype=torch.float32, device=u.device)
              if with_states else None)
    if launch:
        lib = _lib()
        err = lib.ssm_scan_launch(
            u.data_ptr(), ld.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
            state.data_ptr(), None if states is None else states.data_ptr(), bt, s, h, p, n,
            *u.stride(), *ld.stride(), *B.stride(), *C.stride(), *y.stride(),
            chunk, _DTYPES[u.dtype], _CODES[variant],
            torch.cuda.current_stream(u.device).cuda_stream,
        )
        _build.check(lib, err, f"ssm_scan ({variant})")
        ssm_scan.launches += 1
        ssm_scan.variants[variant] += 1
    return y, state, states


class _SsmScan(torch.autograd.Function):
    """The scan with its closed-form backward: the forward saves the
    inputs (and, on the card, the states entering each chunk); the
    backward is ``ssm_scan_bwd``."""

    @staticmethod
    def forward(ctx, u, ld, B, C, chunk):
        h = u.shape[2]
        if u.device.type == "cpu":
            (y, state), states = ssm_scan_chunked(u, ld, _heads(B, h), _heads(C, h), chunk), None
        else:
            y, state, states = _forward(u, ld, _heads(B, h), _heads(C, h), chunk,
                                        with_states=True)
        ctx.save_for_backward(u, ld, B, C, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, d_state):
        u, ld, B, C, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        return (*ssm_scan_bwd(u, ld, B, C, dy, d_state, states=states, chunk=ctx.chunk), None)


def ssm_scan(u, ld, B, C, *, chunk: int | None = None):
    """Chunked SSD scan; returns (y (Bt, S, H, P), state (Bt, H, N, P) f32).

    ``chunk`` is the chunk length T (default ``CHUNK``; the kernel takes
    those of ``CHUNKS``). ``ld`` is read in f32 (a bf16 ``ld`` is widened
    exactly); u, B and C share one dtype, f32 or bf16. B and C have H
    heads or 1 (shared by every head). Differentiable when an input
    requires grad.
    """
    chunk = CHUNK if chunk is None else chunk
    if torch.is_grad_enabled() and any(t.requires_grad for t in (u, ld, B, C)):
        return _SsmScan.apply(u, ld, B, C, chunk)
    h = u.shape[2]
    B, C = _heads(B, h), _heads(C, h)
    if u.device.type == "cpu":
        return ssm_scan_chunked(u, ld, B, C, chunk)
    return _forward(u, ld, B, C, chunk)[:2]


ssm_scan.launches = 0
ssm_scan.variants = dict.fromkeys(VARIANTS, 0)


def ssm_scan_bwd(u, ld, B, C, dy, d_state=None, *, states=None, chunk: int | None = None):
    """``(du, dld, dB, dC)`` of ``ssm_scan(u, ld, B, C, chunk=chunk)``
    given the gradients of its y (``dy``) and of its final state
    (``d_state``, or None where the caller dropped it), each in its
    input's dtype and shape (a head dim of 1 in B and C: the heads'
    gradients summed in f32). CPU tensors take ``ssm_scan_bwd_ref``;
    CUDA tensors launch the backward kernel, which reads the forward's
    ``states`` (``_forward(..., with_states=True)``), or raise.

    ``ssm_scan_bwd.launches`` counts the launches of this process."""
    chunk = CHUNK if chunk is None else chunk
    h = u.shape[2]
    Bh, Ch = _heads(B, h), _heads(C, h)
    if u.device.type == "cpu":
        du, dld, dB, dC = ssm_scan_bwd_ref(u, ld, Bh, Ch, dy, d_state, chunk)
    else:
        du, dld, dB, dC = _backward(u, ld, Bh, Ch, dy, d_state, states, chunk)
    if B.shape[2] != h:  # one B, C for all heads: sum the heads' gradients in f32
        dB, dC = dB.sum(2, keepdim=True), dC.sum(2, keepdim=True)
    return du.to(u.dtype), dld.to(ld.dtype), dB.to(B.dtype), dC.to(C.dtype)


def _backward(u, ld, B, C, dy, d_state, states, chunk):
    """The backward kernel on CUDA tensors (B, C with H heads): du in u's
    dtype, dld f32, dB and dC per head in f32. The kernel runs one block
    per (b, h, 64-column P tile) and writes each tile's share of dld, dB
    and dC; they are summed over the tiles here, in a fixed order."""
    bt, s, h, p = u.shape
    n = B.shape[-1]
    _check_inputs(u, ld, B, C, "ssm_scan_bwd")
    _check(u.dtype, n, chunk)
    nc = -(-s // chunk)
    if dy.shape != u.shape or dy.device != u.device:
        raise ValueError(f"ssm_scan_bwd: dy {tuple(dy.shape)} on {dy.device}, u {tuple(u.shape)}")
    if (states is None or tuple(states.shape) != (bt, h, nc, n, p)
            or states.dtype != torch.float32 or states.device != u.device):
        raise ValueError("ssm_scan_bwd kernel needs the forward's states, (Bt, H, n_chunks, N, "
                         f"P) = ({bt}, {h}, {nc}, {n}, {p}) float32 on {u.device}; got "
                         + ("None" if states is None else
                            f"{tuple(states.shape)} {states.dtype} on {states.device}"))
    if d_state is not None and (tuple(d_state.shape) != (bt, h, n, p)
                                or d_state.device != u.device):
        raise ValueError(f"ssm_scan_bwd: d_state {tuple(d_state.shape)}, want ({bt}, {h}, {n}, {p})")
    dy, ld = dy.to(u.dtype), ld.float()
    states = states.contiguous()
    d_state = None if d_state is None else d_state.float().contiguous()
    npt = -(-p // 64)  # the kernel's P tiles
    du = torch.empty((bt, s, h, p), dtype=u.dtype, device=u.device)
    dld = torch.empty((npt, bt, s, h), dtype=torch.float32, device=u.device)
    dB, dC = (torch.empty((npt, bt, s, h, n), dtype=torch.float32, device=u.device)
              for _ in range(2))
    if not (bt and s and h and p):
        return du.zero_(), dld.sum(0), dB.sum(0), dC.sum(0)
    strides = (ctypes.c_longlong * 19)(*u.stride(), *ld.stride(), *B.stride(), *C.stride(),
                                       *dy.stride())
    lib = _bwd_lib()
    err = lib.ssm_scan_bwd_launch(
        u.data_ptr(), ld.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
        states.data_ptr(), None if d_state is None else d_state.data_ptr(), du.data_ptr(),
        dld.data_ptr(), dB.data_ptr(), dC.data_ptr(), bt, s, h, p, n, strides, chunk,
        _DTYPES[u.dtype], torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(lib, err, "ssm_scan_bwd (fma)")
    ssm_scan_bwd.launches += 1
    ssm_scan_bwd.variants["fma"] += 1
    if npt == 1:
        return du, dld[0], dB[0], dC[0]
    return du, dld.sum(0), dB.sum(0), dC.sum(0)


ssm_scan_bwd.launches = 0
ssm_scan_bwd.variants = {"fma": 0}
