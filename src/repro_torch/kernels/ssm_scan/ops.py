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
``ssm_scan.variants`` counts them by variant. Meta tensors (the
dry-run's accounting, ``kernels/_meta.py``) take the CUDA branch up to
the launch: planned and charged ``work`` (``bwd_work``) with their
variant, counted by the accounting and not in these counters.

B and C come as (Bt, S, H, N), or as (Bt, S, 1, N): one B and C for
every head (Mamba2's layout), which the wrapper expands over the heads
as a view (stride 0) before the kernel or the plain version reads it.

Training: when an input requires grad, ``ssm_scan`` runs through an
autograd ``Function``. On the card its forward asks the kernel for the
f32 state entering each chunk as well (``states``, (Bt, H, n_chunks, N,
P)) and its backward calls ``ssm_scan_bwd``, which launches one of the
hand-written backwards of ``csrc/ssm_scan_bwd.cu``, picked by the same
``plan`` over u, dy, B and C: ``mma`` (bf16 on the tensor cores, for the
layouts the forward's ``mma`` takes; zamba2's training runs it) or
``fma`` (f32 on the CUDA cores, for f32 and other layouts);
``ssm_scan_bwd.launches`` and ``.variants`` count them. On CPU tensors
the Function's forward and backward are the plain ``ssm_scan_chunked``
and ``ssm_scan_bwd_ref``. dB and dC are summed in f32 before the cast to
B's dtype: for a head dim of 1 over the heads, which ``mma`` does on
chip for groups of up to 8 heads (a thread-block cluster) and the
wrapper does for what is left. Without grad (serving, calibration)
nothing changes: no states are stored.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._meta import Work, aligned16, charge, einsum_flops, kernel_device
from .ref import _chunks, ssm_scan_bwd_ref

__all__ = ["CHUNK", "CHUNKS", "STATE_DIMS", "VARIANTS", "MAX_GROUP", "bwd_work", "head_group",
           "plan", "ssm_scan", "ssm_scan_bwd", "ssm_scan_chunked", "work"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (32, 64)  # chunk lengths the kernel is built for
CHUNK = 32  # the default: the faster at zamba2's prefill on an H100, in both variants (PERF.md)
STATE_DIMS = (16, 32, 64, 96)  # N the kernels are built for (reduced, calibration, zamba2,
# mLSTM); P is any
VARIANTS = ("mma", "fma")
_CODES = {"fma": 0, "mma": 1}
# (chunk, N) whose heads' dB, dC slices do not fit a cluster's shared memory:
# the backward's ``ssm_scan_bwd_max_group``, 8 elsewhere (for meta tensors;
# chip_smoke.py holds it to the library's)
MAX_GROUP = {(64, 96): 1}
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
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        lib.ssm_scan_bwd_launch.restype = ctypes.c_int
        lib.ssm_scan_bwd_max_group.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ssm_scan_bwd_max_group.restype = ctypes.c_int
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
    strides of u (b, s, h, p), B and C (b, s, h, n), and for the backward
    dy (b, s, h, p) as well; ``aligned`` says that all their bases are
    16-byte aligned. Raises for what neither
    variant takes: a dtype other than f32 and bf16, N not in
    ``STATE_DIMS`` or a chunk not in ``CHUNKS``."""
    _check(dtype, n, chunk)
    if (dtype == torch.bfloat16 and aligned and p % 8 == 0
            and all(st[3] == 1 and all(x % 8 == 0 for x in st[:3]) for st in strides)):
        return "mma"
    return "fma"


def work(bt, s, h, p, n, es, shared_bc, chunk=CHUNK) -> Work:
    """One forward launch's work. Bytes: each input read once (B and C
    once per step when broadcast over the heads), y and the f32 state
    written once. Operations: per chunk of t steps the lower triangle of
    C B^T and of G U, C S_prev (not in the first chunk, whose S_prev is
    zero) and the state update. FLOPs: the plain ``ssm_scan_chunked``'s
    four einsums over whole chunks of T = min(chunk, S) steps
    (``einsum_flops``: none for one that contracts a dim of 1)."""
    nb = 1 if shared_bc else h
    n_bytes = (2 * bt * s * h * p * es + bt * s * h * 4 + 2 * bt * s * nb * n * es
               + bt * h * n * p * 4)
    ops = 0
    for c0 in range(0, s, chunk):
        t = min(chunk, s - c0)
        tri = t * (t + 1) // 2
        ops += 2 * (tri * n + tri * p + t * n * p * (2 if c0 else 1))
    t = min(chunk, s)
    u = bt * (-(-s // t) if s else 0) * h  # (batch, chunk, head) units of whole chunks
    flops = einsum_flops((t, u * t * n * p), (n, u * t * t * n), (t, u * t * t * p),
                         (n, u * t * n * p))  # S_inc, C B^T, G U, C S_prev
    return Work(n_bytes, float(ops * bt * h), flops)


def bwd_work(bt, s, h, p, n, es, shared_bc, chunk=CHUNK, with_dstate=False) -> Work:
    """One backward launch's work. Bytes: u, dy, ld, B, C, the forward's
    states and d_state read once; du, dld, dB, dC written once (B and C
    and their gradients once per step when shared by the heads).
    Operations: per chunk of t steps the lower triangles of C B^T, dy
    u^T, G dy, A C and A B, and the N x P products S_c dy and the dS update
    (not in the first chunk, whose S_c is zero and whose dS nothing
    reads), and B dS, dS u and <dS, S_c> (not in the last chunk when
    d_state is zero). FLOPs: the plain ``ssm_scan_bwd_ref``'s ten einsums
    over whole chunks of T = min(chunk, S) steps (``einsum_flops``)."""
    nb = 1 if shared_bc else h
    nc = -(-s // chunk)
    n_bytes = (3 * bt * s * h * p * es + 2 * bt * s * h * 4 + 4 * bt * s * nb * n * es
               + bt * h * nc * n * p * 4 + (bt * h * n * p * 4 if with_dstate else 0))
    ops = 0
    for c in range(nc):
        t = min(chunk, s - c * chunk)
        ops += t * (t + 1) // 2 * (3 * n + 2 * p) + (2 * t * n * p if c else 0)
        if c < nc - 1 or with_dstate:
            ops += 2 * t * n * p + (n * p if c else 0)
    t = min(chunk, s)
    u = bt * (-(-s // t) if s else 0) * h
    tnp, ttn, ttp = u * t * n * p, u * t * t * n, u * t * t * p
    flops = einsum_flops((t, tnp), (t, tnp), (n, ttn), (p, ttp), (t, ttp), (n, tnp), (p, tnp),
                         (p, tnp), (t, ttn), (t, ttn))  # the ten products, in ref.py's order
    return Work(n_bytes, float(2 * ops * bt * h), flops)


def head_group(h: int, shared: bool, variant: str, most: int = 8) -> int:
    """The heads over which the backward kernel sums dB and dC on chip:
    ``mma`` with B and C shared by the heads runs a thread-block cluster
    of one block per head, ``most`` blocks at most (8, the portable cluster
    size, or 1 where the kernel's ``ssm_scan_bwd_max_group`` says the
    heads' slices do not fit in shared memory), and as many as divide H;
    otherwise 1 (per-head gradients)."""
    if not shared or variant != "mma":
        return 1
    return next(k for k in (8, 4, 2, 1) if h % k == 0 and k <= most)


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
    if not kernel_device(u) or any(t.device != u.device for t in (ld, B, C)):
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
    variant = plan(u.dtype, n, chunk, p, (u.stride(), B.stride(), C.stride()), aligned16(u, B, C))
    ld = ld.float()
    y = torch.empty((bt, s, h, p), dtype=u.dtype, device=u.device)
    launch = bool(bt and s and h and p)
    # both kernels write every entry of the state: no fill kernel before them
    state = (torch.empty if launch else torch.zeros)((bt, h, n, p), dtype=torch.float32,
                                                     device=u.device)
    states = (torch.empty((bt, h, -(-s // chunk), n, p), dtype=torch.float32, device=u.device)
              if with_states else None)
    if launch and u.device.type == "meta":
        charge("ssm_scan", variant, work(bt, s, h, p, n, u.element_size(), B.stride(2) == 0,
                                         chunk))
    elif launch:
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
    CUDA tensors launch the backward kernel ``plan`` picks, which reads
    the forward's ``states`` (``_forward(..., with_states=True)``), or
    raise.

    ``ssm_scan_bwd.launches`` counts the launches of this process and
    ``ssm_scan_bwd.variants`` counts them by variant."""
    chunk = CHUNK if chunk is None else chunk
    h = u.shape[2]
    Bh, Ch = _heads(B, h), _heads(C, h)
    if u.device.type == "cpu":
        du, dld, dB, dC = ssm_scan_bwd_ref(u, ld, Bh, Ch, dy, d_state, chunk)
    else:
        shared = B.shape[2] != h and C.shape[2] != h
        du, dld, dB, dC = _backward(u, ld, Bh, Ch, dy, d_state, states, chunk, shared=shared,
                                    grad_dtype=B.dtype if B.shape == C.shape
                                    else torch.float32)
    # one B or C for all heads: sum the heads' gradients in f32 (where the
    # kernel has not)
    if dB.shape[2] != B.shape[2]:
        dB = dB.sum(2, keepdim=True)
    if dC.shape[2] != C.shape[2]:
        dC = dC.sum(2, keepdim=True)
    return du.to(u.dtype), dld.to(ld.dtype), dB.to(B.dtype), dC.to(C.dtype)


def _backward(u, ld, B, C, dy, d_state, states, chunk, shared=False, force_fma=False,
              grad_dtype=torch.float32):
    """The backward kernel on CUDA tensors (B, C with H heads, views of
    one B, C when ``shared``): du in u's dtype, dld f32, dB and dC in
    ``grad_dtype``, (Bt, S, H, N), or (Bt, S, 1, N) summed over the heads
    in f32 when ``shared``. The kernel runs one block per (b, h, 64-column
    P tile) and writes each tile's share of dld, dB and dC (``mma`` with
    ``shared``: summed over groups of heads on chip, group-major); they
    are summed over the tiles, groups or heads here, in a fixed order,
    dB and dC in one pass, then cast once. ``force_fma`` launches
    the ``fma`` kernel whatever ``plan`` says (it takes every layout), so
    that a measurement can time both variants on the same inputs."""
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
    variant = "fma" if force_fma else plan(
        u.dtype, n, chunk, p, (u.stride(), dy.stride(), B.stride(), C.stride()),
        aligned16(u, dy, B, C))
    most = (MAX_GROUP.get((chunk, n), 8) if u.device.type == "meta"
            else _bwd_lib().ssm_scan_bwd_max_group(chunk, n))
    group = (head_group(h, shared, variant, most)
             if shared and variant == "mma" and bt and s and p else 1)
    states = states.contiguous()
    d_state = None if d_state is None else d_state.float().contiguous()
    npt = -(-p // 64)  # the kernel's P tiles
    du = torch.empty((bt, s, h, p), dtype=u.dtype, device=u.device)
    dld = torch.empty((npt, bt, s, h), dtype=torch.float32, device=u.device)
    # dB, dC stacked: (2, tiles x groups, Bt, S, N) or per head (2, tiles, Bt, S, H, N)
    shape = (2, npt * (h // group), bt, s, n) if group > 1 else (2, npt, bt, s, h, n)
    dBC = torch.empty(shape, dtype=torch.float32, device=u.device)
    if not (bt and s and h and p):
        dBC = dBC.sum(1)
        dBC = (dBC.sum(3, keepdim=True) if shared else dBC).to(grad_dtype)
        return du.zero_(), dld.sum(0), dBC[0], dBC[1]
    if u.device.type == "meta":
        charge("ssm_scan_bwd", variant, bwd_work(bt, s, h, p, n, u.element_size(), shared,
                                                 chunk, d_state is not None))
    else:
        strides = (ctypes.c_longlong * 19)(*u.stride(), *ld.stride(), *B.stride(), *C.stride(),
                                           *dy.stride())
        lib = _bwd_lib()
        err = lib.ssm_scan_bwd_launch(
            u.data_ptr(), ld.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
            states.data_ptr(), None if d_state is None else d_state.data_ptr(), du.data_ptr(),
            dld.data_ptr(), dBC[0].data_ptr(), dBC[1].data_ptr(), bt, s, h, p, n, strides, chunk,
            _DTYPES[u.dtype], _CODES[variant], group,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
        _build.check(lib, err, f"ssm_scan_bwd ({variant})")
        ssm_scan_bwd.launches += 1
        ssm_scan_bwd.variants[variant] += 1
    dld = dld[0] if npt == 1 else dld.sum(0)
    if group > 1:
        dBC = dBC.sum(1).unsqueeze(3)
    else:
        dBC = dBC[:, 0] if npt == 1 else dBC.sum(1)
        if shared:
            dBC = dBC.sum(3, keepdim=True)
    dBC = dBC.to(grad_dtype)
    return du, dld, dBC[0], dBC[1]


ssm_scan_bwd.launches = 0
ssm_scan_bwd.variants = dict.fromkeys(VARIANTS, 0)
