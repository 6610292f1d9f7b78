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
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["CHUNK", "CHUNKS", "STATE_DIMS", "VARIANTS", "plan", "ssm_scan", "ssm_scan_chunked"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (32, 64)  # chunk lengths the kernel is built for
CHUNK = 32  # the default: the faster at zamba2's prefill on an H100, in both variants (PERF.md)
STATE_DIMS = (16, 32, 64, 96)  # N the kernels are built for (reduced, calibration, zamba2,
# mLSTM); P is any
VARIANTS = ("mma", "fma")
_CODES = {"fma": 0, "mma": 1}
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("ssm_scan")
        lib.ssm_scan_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 19
            + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.ssm_scan_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def plan(dtype: torch.dtype, n: int, chunk: int, p: int, strides, aligned: bool) -> str:
    """The kernel variant for one call. ``strides`` holds the element
    strides of u (b, s, h, p), B and C (b, s, h, n); ``aligned`` says
    that their three bases are 16-byte aligned. Raises for what neither
    variant takes: a dtype other than f32 and bf16, N not in
    ``STATE_DIMS`` or a chunk not in ``CHUNKS``."""
    if dtype not in _DTYPES:
        raise TypeError(f"ssm_scan kernel takes u, B, C in f32 or bf16; got {dtype}")
    if n not in STATE_DIMS or chunk not in CHUNKS:
        raise ValueError(f"ssm_scan kernel: state dim N={n} must be one of {STATE_DIMS} "
                         f"and chunk={chunk} one of {CHUNKS}")
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
    chunk = min(chunk, s)
    pad = -s % chunk
    uf, ldf, Bf, Cf = u.float(), ld.float(), B.float(), C.float()
    if pad:  # identity steps: ld = 0 (decay 1), u = 0, B = 0
        uf, Bf, Cf = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (uf, Bf, Cf))
        ldf = torch.nn.functional.pad(ldf, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    uf = uf.reshape(bt, nc, chunk, h, p)
    ldf = ldf.reshape(bt, nc, chunk, h)
    Bf = Bf.reshape(bt, nc, chunk, h, n)
    Cf = Cf.reshape(bt, nc, chunk, h, n)

    la = torch.cumsum(ldf, dim=2)  # (bt, nc, T, h)
    # Intra-chunk, batched over (bt, nc, h). Mask BEFORE the exp: the
    # j > i entries are positive log-decays whose exp overflows.
    cb = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf)
    li = la[:, :, :, None, :] - la[:, :, None, :, :]
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=u.device).tril()
    lmat = torch.exp(torch.where(tri[None, None, :, :, None], li, -1e30))
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb * lmat, uf)

    # Cross-chunk state: a loop over chunks that carries only the state
    # and keeps the state entering each chunk.
    decay_tot = torch.exp(la[:, :, -1, :])  # (bt, nc, h)
    dec = torch.exp(la[:, :, -1:, :] - la)  # (bt, nc, T, h)
    s_inc = torch.einsum("bcjhn,bcjhp->bchnp", Bf * dec[..., None], uf)
    state = torch.zeros((bt, h, n, p), dtype=torch.float32, device=u.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = decay_tot[:, c, :, None, None] * state + s_inc[:, c]
    states = torch.stack(entering, dim=1)  # (bt, nc, h, n, p)
    y_inter = torch.einsum("bcihn,bchnp->bcihp", Cf, states) * torch.exp(la)[..., None]

    y = (y_intra + y_inter).reshape(bt, nc * chunk, h, p)[:, :s]
    return y.to(u.dtype), state


def ssm_scan(u, ld, B, C, *, chunk: int | None = None):
    """Chunked SSD scan; returns (y (Bt, S, H, P), state (Bt, H, N, P) f32).

    ``chunk`` is the chunk length T (default ``CHUNK``; the kernel takes
    those of ``CHUNKS``). ``ld`` is read in f32 (a bf16 ``ld`` is widened
    exactly); u, B and C share one dtype, f32 or bf16.
    """
    chunk = CHUNK if chunk is None else chunk
    if u.device.type == "cpu":
        return ssm_scan_chunked(u, ld, B, C, chunk)
    bt, s, h, p = u.shape
    n = B.shape[-1]
    if u.device.type != "cuda" or any(t.device != u.device for t in (ld, B, C)):
        raise ValueError(f"ssm_scan: tensors on {u.device}, {ld.device}, {B.device}, {C.device}")
    if (tuple(ld.shape) != (bt, s, h) or tuple(B.shape) != (bt, s, h, n)
            or C.shape != B.shape):
        raise ValueError(f"ssm_scan: shapes u {tuple(u.shape)}, ld {tuple(ld.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    if B.dtype != u.dtype or C.dtype != u.dtype:
        raise TypeError(f"ssm_scan kernel takes u, B, C of one dtype, f32 or bf16; got "
                        f"{u.dtype}, {B.dtype}, {C.dtype}")
    variant = plan(u.dtype, n, chunk, p, (u.stride(), B.stride(), C.stride()),
                   (u.data_ptr() | B.data_ptr() | C.data_ptr()) % 16 == 0)
    if bt > 65535 or h > 65535:
        raise ValueError(f"ssm_scan kernel: batch {bt} and heads {h} must be <= 65535")
    ld = ld.float()
    y = torch.empty((bt, s, h, p), dtype=u.dtype, device=u.device)
    launch = bool(bt and s and h and p)
    # both kernels write every entry of the state: no fill kernel before them
    state = (torch.empty if launch else torch.zeros)((bt, h, n, p), dtype=torch.float32,
                                                     device=u.device)
    if launch:
        lib = _lib()
        err = lib.ssm_scan_launch(
            u.data_ptr(), ld.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
            state.data_ptr(), bt, s, h, p, n,
            *u.stride(), *ld.stride(), *B.stride(), *C.stride(), *y.stride(),
            chunk, _DTYPES[u.dtype], _CODES[variant],
            torch.cuda.current_stream(u.device).cuda_stream,
        )
        _build.check(lib, err, f"ssm_scan ({variant})")
        ssm_scan.launches += 1
        ssm_scan.variants[variant] += 1
    return y, state


ssm_scan.launches = 0
ssm_scan.variants = dict.fromkeys(VARIANTS, 0)
