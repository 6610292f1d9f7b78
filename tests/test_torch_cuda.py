"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: without a card each test skips. Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32, 1e-5 of max|ref| for the matmul (summation order) and
1e-5 absolute for attention (f32 math on both sides, O(1) outputs);
bf16 output, one bf16 rounding more: 2**-8 of each entry, measured
against the f32 result of the same bf16 operands. The SSD scan: 1e-4 of
max|ref| in f32 (summation order over T*N terms, and the chunk's
cumulative log-decay summed in another order inside the exp), plus
2**-8 of each entry of a bf16 y. The ``mma`` variants of attention and
the scan are held to the same tolerances as the ``fma`` ones: they split
the operands the reference keeps in f32 into bf16 terms that keep their
bits (tests/test_torch_attn_plan.py and test_torch_ssm_plan.py emulate it).
The scan's backward (``ssm_scan_bwd``) against ``ssm_scan_bwd_ref`` on
the f32 result of the same operands: f32, 1e-4 of each gradient's
max|ref| (as the forward); bf16, one bf16 rounding of each du, dB and dC
entry (2**-8) plus 1e-3 of the gradient's max|ref| (the states it reads
come from the bf16 forward, which holds 1e-4 of the state's scale; dy is
bf16). Both of its variants are held to it: the one ``plan`` picks (``mma``
for bf16 with 16-byte rows) and ``fma`` forced on the same inputs.
The sLSTM recurrence (``slstm_scan``, f32) against its plain loop on the
same card: 1e-4 of max|ref| for ys and the final state (the matvec's f32
sums in another order, carried through the steps); its backward
(``slstm_scan_bwd`` with ``slstm_dr``) against autograd of the loop:
1e-4 of each gradient's max|ref|. Both of their variants are held to it:
the one ``plan`` picks (``reg`` for d a multiple of 16 up to 192) and
``fma`` forced on the same inputs.
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import dos_matmul, flash_attention, ssm_scan
from repro_torch.kernels.dos_matmul import matmul_ref, plan
from repro_torch.kernels.flash_attention import HEAD_DIMS, attention_ref
from repro_torch.kernels.ssm_scan import CHUNKS, STATE_DIMS, ssm_scan_chunked
from repro_torch.models import build

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (4, 576, 192), (37, 200, 130), (130, 64, 520)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transposed", [False, True])
def test_dos_matmul_kernel(gen, m, k, n, dtype, transposed):
    a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    b = torch.randn(n, k, generator=gen, device="cuda").to(dtype)
    b = b.T if transposed else b.reshape(k, n)
    before = dos_matmul.launches
    out = dos_matmul(a, b)
    assert dos_matmul.launches == before + 1
    exact = matmul_ref(a, b, torch.float32)
    tol = 1e-5 * exact.abs().max() + (2.0**-8 * exact.abs() if dtype == torch.bfloat16 else 0)
    assert out.dtype == dtype
    assert bool(((out.float() - exact).abs() <= tol).all())


def _gemm_operands(gen, m, k, n, transposed, offset=0, dtype=torch.bfloat16):
    """A (m, k), and B (k, n) row-major or as the transposed view of an
    (n, k) table; ``offset`` elements shift A's base off 16 bytes."""
    a = torch.randn(m * k + offset, generator=gen, device="cuda").to(dtype)[offset:].view(m, k)
    b = torch.randn(n, k, generator=gen, device="cuda").to(dtype)
    return a, (b.T if transposed else b.reshape(k, n))


def _plan_of(a, b, out_dtype=None):
    (m, k), n = a.shape, b.shape[1]
    b_t = b.stride(1) != 1
    return plan(m, n, k, a.dtype, b.stride(1) if b_t else b.stride(0), b_t,
                (a.data_ptr() | b.data_ptr()) % 16 == 0, out_dtype)


def _check_variant(a, b, want, out_dtype=None):
    """One call of the wrapper: it must run the planned variant, count it
    once, and agree with the f32 result of the same operands."""
    out_dtype = out_dtype or a.dtype
    assert _plan_of(a, b, out_dtype).variant == want
    before = dict(dos_matmul.variants)
    out = dos_matmul(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert dos_matmul.variants == dict(before, **{want: before[want] + 1})
    exact = matmul_ref(a, b, torch.float32)
    tol = 1e-5 * exact.abs().max() + (2.0**-8 * exact.abs() if out_dtype == torch.bfloat16 else 0)
    assert out.dtype == out_dtype
    assert bool(((out.float() - exact).abs() <= tol).all())
    return out


@pytest.mark.parametrize("k", [576, 2560, 10240])
@pytest.mark.parametrize("n", [64, 80, 192, 2560])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("transposed", [False, True])
def test_dos_matmul_skinny(gen, m, n, k, transposed):
    _check_variant(*_gemm_operands(gen, m, k, n, transposed), "skinny")


@pytest.mark.parametrize("k", [576, 2560])
@pytest.mark.parametrize("n", [64, 80, 2560, 32000])
@pytest.mark.parametrize("m", [17, 64, 200, 512])
@pytest.mark.parametrize("transposed", [False, True])
def test_dos_matmul_wgmma(gen, m, n, k, transposed):
    _check_variant(*_gemm_operands(gen, m, k, n, transposed), "wgmma")


@pytest.mark.parametrize("m,want", [(4, "skinny"), (512, "wgmma")])
def test_dos_matmul_tied_unembed_view(gen, m, want):
    """smollm's tied head: x @ tok.T with tok (49152, 576), no copy."""
    _check_variant(*_gemm_operands(gen, m, 576, 49152, True), want)


@pytest.mark.parametrize("m,k,n,transposed,offset", [
    (37, 200, 130, False, 0),  # ldb = N = 130
    (64, 100, 256, False, 0),  # K = 100
    (64, 256, 256, False, 1),  # A's base 2 bytes off 16
    (65, 100, 300, True, 0),   # transposed, ldb = K = 100
])
def test_dos_matmul_general(gen, m, k, n, transposed, offset):
    _check_variant(*_gemm_operands(gen, m, k, n, transposed, offset), "general")


@pytest.mark.parametrize("m,k,n,transposed,offset", [(3, 200, 130, False, 1), (16, 100, 300, True, 0)])
def test_dos_matmul_skinny_unaligned(gen, m, k, n, transposed, offset):
    _check_variant(*_gemm_operands(gen, m, k, n, transposed, offset), "skinny")


@pytest.mark.parametrize("m,k", [(4, 2560), (16, 576), (512, 2560)])
@pytest.mark.parametrize("n", [80, 2560])
@pytest.mark.parametrize("transposed", [False, True])
def test_dos_matmul_f32_output_of_bf16(gen, m, k, n, transposed):
    """bf16 operands asked for an f32 output run the general kernel at any
    M (skinny and wgmma store bf16 only), held to the f32 tolerance."""
    _check_variant(*_gemm_operands(gen, m, k, n, transposed), "general", torch.float32)


# the bit-identity cases whose K is split over a cluster
_SPLIT_CASES = {(4, 10240, 2560), (16, 2560, 64), (512, 2560, 64)}


@pytest.mark.parametrize("m,k,n,transposed,offset,dtype,want", [
    (4, 10240, 2560, False, 0, torch.bfloat16, "skinny"),
    (16, 2560, 64, False, 0, torch.bfloat16, "skinny"),      # 4 row chunks, a K split
    (4, 576, 49152, True, 0, torch.bfloat16, "skinny"),
    (512, 2560, 64, False, 0, torch.bfloat16, "wgmma"),      # a K split over a cluster
    (512, 2560, 2560, False, 0, torch.bfloat16, "wgmma"),
    (512, 576, 4096, True, 0, torch.bfloat16, "wgmma"),
    (37, 200, 130, False, 0, torch.bfloat16, "general"),
    (4, 576, 192, False, 0, torch.float32, "f32"),
])
def test_dos_matmul_bit_identical(gen, m, k, n, transposed, offset, dtype, want):
    """Two calls on the same inputs give the same bits: K splits meet in
    a fixed order, with no atomics."""
    a, b = _gemm_operands(gen, m, k, n, transposed, offset, dtype)
    if (m, k, n) in _SPLIT_CASES:
        assert _plan_of(a, b).split > 1  # partial tiles meet over the cluster
    first = _check_variant(a, b, want)
    assert torch.equal(first, dos_matmul(a, b))


def test_dos_matmul_rejects_mixed_dtypes(gen):
    a = torch.randn(4, 8, generator=gen, device="cuda")
    with pytest.raises(TypeError):
        dos_matmul(a, a.T.to(torch.bfloat16))


@pytest.mark.parametrize("case", [
    (2, 128, 128, 9, 3, 64, True, None, 0),
    (1, 200, 200, 4, 1, 256, True, 48, 0),
    (2, 33, 90, 4, 2, 32, True, None, 57),
    (1, 70, 70, 2, 2, 128, False, None, 0),
    (1, 70, 70, 2, 1, 64, True, 0, 0),  # no visible key: mean(v), as the reference
    (4, 128, 128, 32, 32, 80, True, None, 0),  # zamba2's shared attention, D 80
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(gen, case, dtype):
    b, sq, skv, h, kvh, d, causal, window, q_offset = case
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, skv, kvh, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, skv, kvh, d, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    exact = attention_ref(q.float(), k.float(), v.float(), **kw)
    tol = 1e-5 + (2.0**-8 * exact.abs() if dtype == torch.bfloat16 else 0)
    assert bool(((out.float() - exact).abs() <= tol).all())


def _off16(t):
    """``t``'s values in a tensor of its shape whose base lies 2 bytes off
    16-byte alignment (the layouts the mma variants do not take)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _check_flash_variant(q, k, v, want, **kw):
    """One call: it must run the planned variant, count it once, and agree
    with the f32 result of the same operands."""
    before = dict(flash_attention.variants)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.variants == dict(before, **{want: before[want] + 1})
    exact = attention_ref(q.float(), k.float(), v.float(), **kw)
    tol = 1e-5 + (2.0**-8 * exact.abs() if q.dtype == torch.bfloat16 else 0)
    assert bool(((out.float() - exact).abs() <= tol).all())
    return out


_FLASH_CASES = [  # b, sq, skv, h, kvh, causal, window, q_offset
    (4, 128, 128, 9, 3, True, 2**30, 0),    # smollm's prefill (global layers' sentinel)
    (4, 128, 128, 32, 32, True, None, 0),   # zamba2's shared attention
    (2, 200, 200, 4, 1, True, 48, 0),       # ragged, window, MQA
    (2, 33, 90, 4, 2, True, None, 57),      # queries at an offset, ragged tails
    (1, 70, 70, 2, 2, False, None, 0),      # no mask
    (1, 70, 70, 2, 1, True, 0, 0),          # no visible key: mean(v)
]


@pytest.mark.parametrize("case", _FLASH_CASES)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("layout", ["aligned", "offset"])
def test_flash_attention_variants(gen, case, d, layout):
    """bf16 at every head dim: aligned operands run mma, operands 2 bytes
    off 16-byte alignment run fma, both within the bf16 tolerance."""
    b, sq, skv, h, kvh, causal, window, q_offset = case
    q, k, v = (torch.randn(b, s, hh, d, generator=gen, device="cuda").to(torch.bfloat16)
               for s, hh in ((sq, h), (skv, kvh), (skv, kvh)))
    want = "mma"
    if layout == "offset":
        q, k, v, want = _off16(q), _off16(k), _off16(v), "fma"
    _check_flash_variant(q, k, v, want, causal=causal, window=window, q_offset=q_offset)


@pytest.mark.parametrize("d", [64, 80])
def test_flash_attention_strided_rows(gen, d):
    """q, k, v as column slices of one fused (B, S, H, 3D) projection:
    rows 16-byte aligned, so mma, read through the strides."""
    qkv = torch.randn(2, 128, 4, 3 * d, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    _check_flash_variant(q, k, v, "mma")


@pytest.mark.parametrize("case", [(4, 128, 9, 3, 64), (4, 128, 32, 32, 80), (2, 200, 4, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_bit_identical(gen, case, dtype):
    """Two calls on the same inputs give the same bits (no atomics)."""
    b, s, h, kvh, d = case
    q, k, v = (torch.randn(b, s, hh, d, generator=gen, device="cuda").to(dtype)
               for hh in (h, kvh, kvh))
    first = _check_flash_variant(q, k, v, "mma" if dtype == torch.bfloat16 else "fma")
    assert torch.equal(first, flash_attention(q, k, v))


def test_dos_matmul_rejects_b_without_unit_stride(gen):
    a = torch.randn(4, 8, generator=gen, device="cuda")
    b = torch.randn(16, 12, generator=gen, device="cuda")[::2, ::2]
    with pytest.raises(ValueError):
        dos_matmul(a, b)


def _ssm_inputs(gen, bt, s, h, p, n, dtype, shared_bc):
    """Mamba2's inputs: ld = dt * A, dt = softplus(normal), A = -[1..H]."""
    u = torch.randn(bt, s, h, p, generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(bt, s, h, generator=gen, device="cuda"))
    ld = -dt * torch.arange(1, h + 1, device="cuda", dtype=torch.float32)
    nb = 1 if shared_bc else h
    B, C = (torch.randn(bt, s, nb, n, generator=gen, device="cuda").to(dtype).expand(-1, -1, h, -1)
            for _ in range(2))
    return u, ld, B, C


@pytest.mark.parametrize("case", [
    (4, 128, 80, 64, 64, True),   # zamba2's prefill, B/C broadcast over the heads
    (2, 200, 8, 64, 64, True),    # ragged S
    (2, 20, 4, 64, 64, False),    # S below the chunk
    (1, 512, 4, 64, 64, True),    # many chunks
    (2, 40, 16, 16, 16, False),   # the reduced configs' N = P = 16
    (1, 100, 2, 192, 96, False),  # P over several tiles, N 96
    (1, 33, 2, 1, 96, False),     # P = 1, N 96: mLSTM's normaliser
    (8, 512, 4, 192, 96, False),  # xlstm-125m's mLSTM memory at its training shape
    (8, 512, 4, 1, 96, False),    # and its normaliser
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_ssm_scan_kernel(gen, case, dtype, chunk):
    u, ld, B, C = _ssm_inputs(gen, *case[:5], dtype, case[5])
    before = ssm_scan.launches
    y, state = ssm_scan(u, ld, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    assert y.dtype == dtype and state.dtype == torch.float32
    ey, es = ssm_scan_chunked(u.float(), ld, B.float(), C.float(), chunk=chunk)
    ytol = 1e-4 * ey.abs().max() + (2.0**-8 * ey.abs() if dtype == torch.bfloat16 else 0)
    assert bool(((y.float() - ey).abs() <= ytol).all())
    assert bool(((state - es).abs() <= 1e-4 * es.abs().max()).all())


def _check_ssm_variant(u, ld, B, C, chunk, want):
    before = dict(ssm_scan.variants)
    y, state = ssm_scan(u, ld, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssm_scan.variants == dict(before, **{want: before[want] + 1})
    ey, es = ssm_scan_chunked(u.float(), ld, B.float(), C.float(), chunk=chunk)
    ytol = 1e-4 * ey.abs().max() + (2.0**-8 * ey.abs() if u.dtype == torch.bfloat16 else 0)
    assert bool(((y.float() - ey).abs() <= ytol).all())
    assert bool(((state - es).abs() <= 1e-4 * es.abs().max()).all())
    return y, state


_SSM_CASES = [  # bt, s, h, p, B/C broadcast
    (4, 128, 80, 64, True),    # zamba2's prefill
    (2, 200, 8, 64, True),     # ragged S
    (2, 20, 4, 64, False),     # S below the chunk
    (1, 512, 4, 64, True),     # many chunks
    (1, 100, 2, 192, False),   # P over several tiles
    (2, 40, 3, 40, False),     # a ragged P tile (P = 40)
]


@pytest.mark.parametrize("case", _SSM_CASES)
@pytest.mark.parametrize("n", STATE_DIMS)
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("layout", ["aligned", "offset", "strided"])
def test_ssm_scan_variants(gen, case, n, chunk, layout):
    """bf16 at every N and chunk: aligned inputs run mma; u 2 bytes off
    16-byte alignment, or u read with a stride of 2 along P, run fma."""
    bt, s, h, p, shared = case
    u, ld, B, C = _ssm_inputs(gen, bt, s, h, p, n, torch.bfloat16, shared)
    want = "mma"
    if layout == "offset":
        u, want = _off16(u), "fma"
    elif layout == "strided":
        u, want = torch.stack([u, u], dim=-1).flatten(-2)[..., ::2], "fma"
        assert u.stride(-1) == 2
    _check_ssm_variant(u, ld, B, C, chunk, want)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssm_scan_bit_identical(gen, chunk, dtype):
    """Two calls on the same inputs give the same bits (no atomics)."""
    u, ld, B, C = _ssm_inputs(gen, 4, 128, 80, 64, 64, dtype, True)
    y, st = _check_ssm_variant(u, ld, B, C, chunk, "mma" if dtype == torch.bfloat16 else "fma")
    y2, st2 = ssm_scan(u, ld, B, C, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(st, st2)


# bt, s, h, p, n, B/C shared by the heads (a head dim of 1)
_SSM_BWD_CASES = [
    (8, 512, 80, 64, 64, True),   # zamba2's training shape
    (2, 200, 8, 64, 64, True),    # ragged S
    (2, 20, 4, 64, 64, False),    # S below the chunk
    (2, 40, 16, 16, 16, False),   # the reduced configs' N = P = 16
    (2, 40, 3, 40, 32, True),     # a ragged P tile, N 32
    (1, 100, 2, 192, 96, False),  # P over several tiles, N 96
    (1, 33, 2, 1, 96, False),     # P = 1, N 96: mLSTM's normaliser
    (8, 512, 4, 192, 96, False),  # xlstm-125m's mLSTM memory at its training shape
    (8, 512, 4, 1, 96, False),    # and its normaliser
]


def _ssm_bwd_case(gen, case, dtype, chunk, with_dstate):
    """Inputs, dy, d_state and the forward's states (the kernel's)."""
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    bt, s, h, p, n, shared = case
    u, ld, B, C = _ssm_inputs(gen, bt, s, h, p, n, dtype, False)
    if shared:
        B, C = B[:, :, :1], C[:, :, :1]
    dy = torch.randn(bt, s, h, p, generator=gen, device="cuda").to(dtype)
    ds = torch.randn(bt, h, n, p, generator=gen, device="cuda") if with_dstate else None
    _, _, states = ssm_ops._forward(u, ld, B.expand(-1, -1, h, -1), C.expand(-1, -1, h, -1),
                                    chunk, with_states=True)
    return u, ld, B, C, dy, ds, states


def _check_ssm_bwd(got, u, ld, B, C, dy, ds, chunk):
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd_ref

    h = u.shape[2]
    e = ssm_scan_bwd_ref(u.float(), ld, B.float().expand(-1, -1, h, -1),
                         C.float().expand(-1, -1, h, -1), dy.float(), ds, chunk)
    if B.shape[2] == 1:
        e = (e[0], e[1], e[2].sum(2, keepdim=True), e[3].sum(2, keepdim=True))
    bf16 = u.dtype == torch.bfloat16
    for g, x, rounded in zip(got, e, (True, False, True, True)):
        assert g.shape == x.shape
        tol = (1e-3 if bf16 else 1e-4) * x.abs().max() + (2.0**-8 * x.abs() if bf16 and rounded
                                                          else 0)
        assert bool(((g.float() - x).abs() <= tol).all())


def _ssm_bwd_variant(dtype, p, force_fma):
    """The variant a backward call launches: mma for bf16 with P a multiple
    of 8 (these inputs' rows start on 16 bytes), fma for the rest and when
    forced."""
    return "mma" if dtype == torch.bfloat16 and p % 8 == 0 and not force_fma else "fma"


def _run_ssm_bwd(u, ld, B, C, dy, ds, states, chunk, force_fma):
    """``ssm_scan_bwd``, or the fma kernel forced on the same inputs (through
    the wrapper's sums and casts)."""
    from repro_torch.kernels import ssm_scan_bwd
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    if not force_fma:
        return ssm_scan_bwd(u, ld, B, C, dy, ds, states=states, chunk=chunk)
    h = u.shape[2]
    return ssm_ops._backward(u, ld, B.expand(-1, -1, h, -1), C.expand(-1, -1, h, -1), dy, ds,
                             states, chunk, shared=B.shape[2] != h, force_fma=True,
                             grad_dtype=u.dtype)


@pytest.mark.parametrize("case", _SSM_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("force_fma", [False, True])
def test_ssm_scan_bwd_kernel(gen, case, dtype, chunk, with_dstate, force_fma):
    from repro_torch.kernels import ssm_scan_bwd

    u, ld, B, C, dy, ds, states = _ssm_bwd_case(gen, case, dtype, chunk, with_dstate)
    want = _ssm_bwd_variant(dtype, u.shape[3], force_fma)
    before = (ssm_scan_bwd.launches, dict(ssm_scan_bwd.variants))
    got = _run_ssm_bwd(u, ld, B, C, dy, ds, states, chunk, force_fma)
    torch.cuda.synchronize()
    assert ssm_scan_bwd.launches == before[0] + 1
    assert ssm_scan_bwd.variants == dict(before[1], **{want: before[1][want] + 1})
    assert [g.dtype for g in got] == [dtype, torch.float32, dtype, dtype]
    _check_ssm_bwd(got, u, ld, B, C, dy, ds, chunk)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssm_scan_states_are_the_states_entering_each_chunk(gen, chunk, dtype):
    """Both variants' per-chunk states: chunk c's is the final state of the
    scan over the first c chunks (zero for the first), and y and the final
    state are the same bits as without states."""
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    u, ld, B, C = _ssm_inputs(gen, 2, 200, 8, 64, 64, dtype, True)
    y, st, states = ssm_ops._forward(u, ld, B, C, chunk, with_states=True)
    y0, st0 = ssm_scan(u, ld, B, C, chunk=chunk)
    assert torch.equal(y, y0) and torch.equal(st, st0)
    assert states.shape == (2, 8, -(-200 // chunk), 64, 64)
    assert bool((states[:, :, 0] == 0).all())
    for c in range(1, states.shape[2]):
        s = c * chunk
        _, want = ssm_scan_chunked(u[:, :s].float(), ld[:, :s], B[:, :s].float(),
                                   C[:, :s].float(), chunk=chunk)
        assert bool(((states[:, :, c] - want).abs() <= 1e-4 * want.abs().max()).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("force_fma", [False, True])
def test_ssm_scan_bwd_bit_identical(gen, dtype, force_fma):
    """Two calls on the same inputs give the same bits (no atomics; mma's
    heads summed on chip in rank order)."""
    from repro_torch.kernels import ssm_scan_bwd

    u, ld, B, C, dy, ds, states = _ssm_bwd_case(gen, _SSM_BWD_CASES[0], dtype, 32, True)
    want = _ssm_bwd_variant(dtype, u.shape[3], force_fma)
    before = dict(ssm_scan_bwd.variants)
    a = _run_ssm_bwd(u, ld, B, C, dy, ds, states, 32, force_fma)
    b = _run_ssm_bwd(u, ld, B, C, dy, ds, states, 32, force_fma)
    assert ssm_scan_bwd.variants == dict(before, **{want: before[want] + 2})
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssm_scan_function_on_the_card(gen, dtype):
    """Autograd through ssm_scan on the card: one forward launch (with
    states), one backward launch (mma for bf16); the gradients those of
    ssm_scan_bwd on the same states."""
    from repro_torch.kernels import ssm_scan_bwd

    u, ld, B, C, dy, _, states = _ssm_bwd_case(gen, (2, 100, 8, 64, 64, True), dtype, 32, False)
    ins = [t.detach().clone().requires_grad_() for t in (u, ld, B, C)]
    before = (ssm_scan.launches, ssm_scan_bwd.launches)
    variants = dict(ssm_scan_bwd.variants)
    y, _ = ssm_scan(*ins)
    got = torch.autograd.grad(y, ins, dy)
    assert (ssm_scan.launches, ssm_scan_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = "mma" if dtype == torch.bfloat16 else "fma"
    assert ssm_scan_bwd.variants == dict(variants, **{want: variants[want] + 1})
    want = ssm_scan_bwd(u, ld, B, C, dy, states=states)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ssm_scan_bwd_needs_the_forwards_states(gen):
    from repro_torch.kernels import ssm_scan_bwd

    u, ld, B, C = _ssm_inputs(gen, 1, 40, 2, 16, 16, torch.float32, False)
    with pytest.raises(ValueError, match="states"):
        ssm_scan_bwd(u, ld, B, C, torch.ones_like(u))


def test_ssm_scan_rejects_unbuilt_state_dims(gen):
    u, ld, B, C = _ssm_inputs(gen, 1, 8, 2, 8, 24, torch.float32, False)
    with pytest.raises(ValueError, match="state dim"):
        ssm_scan(u, ld, B, C)


# ---------------------------------------------------------------------------
# calibration's shapes (core/calibrate.py): f32 operands, so the fma variants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [  # b, s, h, kvh, d: every prefill row of the three presets
    (1, 256, 8, 2, 64), (1, 512, 8, 8, 64), (1, 1024, 8, 2, 64), (2, 512, 16, 4, 64),
    (1, 1024, 16, 1, 64),  # MQA: 16 query heads on one KV head
    (1, 2048, 8, 2, 64),   # S 2048 (the full preset)
])
def test_flash_attention_calibration_shapes(gen, case):
    b, s, h, kvh, d = case
    q, k, v = (torch.randn(b, s, hh, d, generator=gen, device="cuda") for hh in (h, kvh, kvh))
    _check_flash_variant(q, k, v, "fma", causal=True)


@pytest.mark.parametrize("case", [  # bt, s, h, p, n: every SSM row of the three presets
    (1, 256, 8, 64, 64), (2, 1024, 8, 64, 64), (1, 512, 8, 64, 64), (4, 512, 4, 32, 64),
    (2, 2048, 4, 64, 32),  # N 32
    (4, 2048, 8, 64, 64), (1, 4096, 16, 64, 64),
])
def test_ssm_scan_calibration_shapes(gen, case):
    """The calibration draws u, B, C per head (no broadcast) with ld in
    [-0.2, -0.01]; held here with Mamba2's decays, which are harder."""
    u, ld, B, C = _ssm_inputs(gen, *case, torch.float32, False)
    _check_ssm_variant(u, ld, B, C, 32, "fma")


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "mma"), (torch.float32, "fma")])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_ssm_scan_state_dim_32(gen, dtype, want, chunk):
    """N = 32 in both variants: ragged S and P tile, B/C per head and broadcast."""
    for bt, s, h, p, shared in ((2, 200, 8, 64, True), (1, 70, 3, 40, False)):
        u, ld, B, C = _ssm_inputs(gen, bt, s, h, p, 32, dtype, shared)
        _check_ssm_variant(u, ld, B, C, chunk, want)


def test_engine_torch_search_on_card_matches_numpy(gen):
    """``backend='torch'`` on the card against ``backend='numpy'``: equal
    int64 rows, cols and cycles and equal derived metrics on a seeded grid
    with every dataflow and fold, and on the dse sweep's workloads."""
    import numpy as np

    from repro_torch.core import engine

    rng = np.random.default_rng(0)
    wl = np.stack([rng.integers(1, 700, 12), rng.integers(1, 12100, 12),
                   rng.integers(1, 3000, 12)], axis=1)
    grid = engine.DesignGrid(workloads=wl, tiers=np.repeat([1, 2, 5, 16], 4),
                             mac_budgets=np.array([1, 2**10, 2**14, 2**18] * 4),
                             dataflow=np.array(["os", "dos", "ws", "is"] * 4),
                             fold=np.array(["m", "k", "n", "k"] * 4))
    got = engine.evaluate(grid, backend="torch")
    want = engine.evaluate(grid)
    for name in ("rows", "cols", "cycles", "speedup", "power_w", "t_max_c"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), name
    for a, b in zip(engine.optimal_tiers_batched(wl, [2**14, 2**16, 2**18], backend="torch"),
                    engine.optimal_tiers_batched(wl, [2**14, 2**16, 2**18])):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("macs,tiers,tech", [(65536, 1, "2d"), (16384, 3, "miv")])
def test_thermal_solve_on_card_is_bit_identical_to_cpu(gen, macs, tiers, tech):
    """The grid Jacobi solve on the card (its chunks replayed from a CUDA
    graph) against the same solve on the CPU: the same f32 operations in
    the same order, so the same bits and the same stop iteration."""
    from repro_torch.core.ppa import thermal

    side = int(macs**0.5)
    q, _ = thermal._power_map(128, 300, 128, side, side, tiers, tech)
    area = 0.01 * macs / 4096
    T, it = thermal._solve_stack(q, area, tiers, tech)
    T_cpu, it_cpu = thermal._solve_stack(q, area, tiers, tech, "cpu")
    assert T.device.type == "cuda" and it == it_cpu < thermal._MAX_ITERS
    assert torch.equal(T.cpu(), T_cpu)


# --- training: the forward's lse, the flash backward, both Functions --------
#
# lse: f32 math on both sides, 1e-5 absolute plus 1e-6 of |lse| (one log
# of an f32 sum). The backward: f32, 1e-5 of the largest gradient entry
# (at least 1e-5 absolute: summation order); a bf16 gradient adds one
# rounding, 2**-8 of each entry, against the f32 result of the same bf16
# operands (o, dO and lse included). The Functions' gradients: autograd
# of the plain versions on the same card within the same bands.

_BWD_CASES = [  # b, sq, skv, h, kvh, d, causal, window, q_offset
    (2, 128, 128, 9, 3, 64, True, 2**30, 0),  # smollm's heads, the global sentinel
    (2, 128, 128, 4, 4, 64, True, None, 0),
    (2, 128, 128, 16, 1, 64, True, None, 0),
    (2, 128, 128, 8, 2, 64, True, None, 0),
    (2, 256, 256, 4, 1, 256, True, 64, 0),  # gemma3's window
    (2, 200, 333, 4, 2, 64, False, None, 0),  # ragged
    (2, 64, 200, 4, 2, 32, True, 16, 136),  # queries at the end, a window
    (1, 70, 70, 2, 1, 64, True, 0, 0),  # no row sees a key: dV = mean weights
]


def _bwd_inputs(gen, b, sq, skv, h, kvh, d, dtype):
    return tuple(torch.randn(b, s, hh, d, generator=gen, device="cuda").to(dtype)
                 for s, hh in ((sq, h), (skv, kvh), (skv, kvh), (sq, h)))


def _within(got, exact, dtype):
    tol = 1e-5 * max(1.0, exact.abs().max().item())
    if dtype == torch.bfloat16:
        tol = tol + 2.0**-8 * exact.abs()
    return bool(((got.float() - exact).abs() <= tol).all())


@pytest.mark.parametrize("case", _BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_and_backward(gen, case, dtype):
    from repro_torch.kernels import flash_attention_bwd
    from repro_torch.kernels.flash_attention import attention_bwd_ref, attention_fwd_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops

    b, sq, skv, h, kvh, d, causal, window, q_offset = case
    q, k, v, do = _bwd_inputs(gen, b, sq, skv, h, kvh, d, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = flash_ops._forward(q, k, v, scale=None, with_lse=True, **kw)
    _, want_lse = attention_fwd_ref(q.float(), k.float(), v.float(), **kw)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert bool(((lse - want_lse).abs() <= 1e-5 + 1e-6 * want_lse.abs().clamp(max=1e6)).all())
    before = flash_attention_bwd.launches
    grads = flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert flash_attention_bwd.launches == before + 1
    exact = attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), do.float(), lse, **kw)
    for got, want, like in zip(grads, exact, (q, k, v)):
        assert got.dtype == dtype and got.shape == like.shape
        assert _within(got, want, dtype)
    again = flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))  # no atomics


_BWD_VARIANT_CASES = [  # b, sq, skv, h, kvh, causal, window, q_offset
    (2, 128, 128, 4, 4, True, None, 0),  # GQA 4/4
    (2, 128, 128, 16, 1, True, None, 0),  # 16/1
    (2, 128, 128, 8, 2, True, None, 0),  # 8/2
    (2, 256, 256, 4, 1, True, 96, 0),  # a window that binds
    (2, 64, 200, 4, 2, True, None, 136),  # queries at the end of the keys
    (2, 200, 333, 4, 2, False, None, 0),  # ragged, no mask
    (1, 70, 70, 2, 1, True, 0, 0),  # no row sees a key
]


@pytest.mark.parametrize("case", _BWD_VARIANT_CASES)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("layout", ["aligned", "seq stride 2", "offset"])
def test_flash_attention_bwd_variants(gen, case, d, layout):
    """The bf16 backward at every head dim: aligned rows and rows read
    through a sequence stride of 2 run mma, bases 2 bytes off 16 run fma;
    each within the gate above against the f32 backward of the same
    operands, and two calls give the same bits (no atomics)."""
    from repro_torch.kernels import flash_attention_bwd
    from repro_torch.kernels.flash_attention import attention_bwd_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops

    b, sq, skv, h, kvh, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    stride = 2 if layout == "seq stride 2" else 1
    q, k, v, do = (t[:, ::stride] for t in _bwd_inputs(gen, b, stride * sq, stride * skv, h, kvh,
                                                        d, torch.bfloat16))
    if layout == "offset":
        q, k, v, do = (_off16(t) for t in (q, k, v, do))
    o, lse = flash_ops._forward(q, k, v, scale=None, with_lse=True, **kw)
    want = "fma" if layout == "offset" else "mma"
    before = dict(flash_attention_bwd.variants)
    grads = flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert flash_attention_bwd.variants == dict(before, **{want: before[want] + 1})
    exact = attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), do.float(), lse, **kw)
    for got, ref, like in zip(grads, exact, (q, k, v)):
        assert got.dtype == torch.bfloat16 and got.shape == like.shape
        assert _within(got, ref, torch.bfloat16)
    again = flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


def test_flash_attention_without_grad_stores_no_lse_and_launches_as_before(gen):
    from repro_torch.kernels import flash_attention_bwd

    q, k, v, _ = _bwd_inputs(gen, 2, 64, 64, 4, 2, 64, torch.bfloat16)
    before = (dict(flash_attention.variants), flash_attention_bwd.launches)
    with torch.no_grad():
        flash_attention(q, k, v)
    assert flash_attention.variants["mma"] == before[0]["mma"] + 1
    assert flash_attention_bwd.launches == before[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_function_gradients(gen, dtype):
    from repro_torch.kernels import flash_attention_bwd

    q, k, v, do = _bwd_inputs(gen, 2, 96, 96, 6, 2, 64, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_attention_bwd.launches
    got = torch.autograd.grad(flash_attention(*leaves, window=48), leaves, do)
    assert flash_attention_bwd.launches == before + 1
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ref_leaves, window=48), ref_leaves, do.float())
    for g, w in zip(got, want):
        assert g.dtype == dtype
        # bf16: the forward's o is rounded to bf16 before D = rowsum(dO o),
        # so the band is the bf16 one of each entry and of the scale
        tol = (3e-2 * w.abs().max().item() if dtype == torch.bfloat16
               else 1e-5 * max(1.0, w.abs().max().item()))
        assert (g.float() - w).abs().max().item() <= tol


@pytest.mark.parametrize("m,k,n,tied", [(4096, 576, 576, False), (4096, 576, 192, False),
                                        (4096, 576, 1536, False), (4096, 1536, 576, False),
                                        (4096, 576, 49152, True)])
def test_dos_matmul_function_gradients(gen, m, k, n, tied):
    """dA and dB of the Function (two more wgmma launches) against autograd
    of matmul_ref, at smollm's training projections and the tied unembed."""
    a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(n, k, generator=gen, device="cuda").T if tied else \
        torch.randn(k, n, generator=gen, device="cuda")
    dc = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
    a1, w1 = a.clone().requires_grad_(), w.detach().clone().requires_grad_()
    before = dict(dos_matmul.variants)
    torch.autograd.backward(dos_matmul(a1, w1.to(torch.bfloat16)), dc)
    assert {v: dos_matmul.variants[v] - before[v] for v in before} == \
        {"skinny": 0, "wgmma": 3, "general": 0, "f32": 0}
    a2, w2 = a.clone().requires_grad_(), w.detach().clone().requires_grad_()
    torch.autograd.backward(matmul_ref(a2, w2.to(torch.bfloat16)), dc)
    wb = w.to(torch.bfloat16)
    exact = (dc.float() @ wb.float().T, a.float().T @ dc.float())  # f32 sums, same operands
    for got, want, ex, depth in ((a1.grad, a2.grad, exact[0], n), (w1.grad, w2.grad, exact[1], m)):
        assert got.dtype == want.dtype and got.shape == want.shape
        # each rounds an f32 sum of the same bf16 products to bf16 once; the
        # sum's own error, 1e-5 of the largest entry, grows linearly with its
        # depth past 8192 terms (the tensor cores' f32 adds truncate)
        tol = 2.0**-8 * ex.abs() + 1e-5 * max(1.0, depth / 8192) * ex.abs().max()
        assert bool(((got.float() - ex).abs() <= tol).all())
        assert bool(((want.float() - ex).abs() <= tol).all())


# B, S, H, d, a non-zero initial state (decode's cache)
_SLSTM_CASES = [
    (8, 512, 4, 192, False),  # xlstm-125m's training shape
    (4, 128, 4, 192, False),  # its serving prefill
    (4, 1, 4, 192, True),     # a decode step
    (2, 77, 4, 32, True),     # the reduced width, a ragged S
    (3, 20, 3, 40, True),     # a width off 32
]
SLSTM_TOL = 1e-4


def _slstm_inputs(gen, b, s, h, d, with_state):
    e = h * d

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    ins = [rn(b, s, e), rn(b, s, h, scale=2.0), rn(b, s, h, scale=2.0) + 1.0, rn(b, s, e),
           rn(h, d, d, scale=0.1)]
    if with_state:
        ins += [rn(b, e), rn(b, h).abs() + 0.5, rn(b, e, scale=0.5)]
    else:
        ins += [torch.zeros(b, e, device="cuda"), torch.zeros(b, h, device="cuda"),
                torch.zeros(b, e, device="cuda")]
    return ins


def _close_rel(got, want, tol):
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= tol * max(want.abs().max().item(), 1e-30)


@pytest.mark.parametrize("case", _SLSTM_CASES)
@pytest.mark.parametrize("variant", ["planned", "fma"])
def test_slstm_scan_kernel(gen, case, variant):
    """The variant ``plan`` picks (``reg`` at d 192 and 32, ``fma`` at d
    40) through the op, and ``fma`` forced on the same inputs."""
    from repro_torch.kernels import slstm_scan
    from repro_torch.kernels.slstm import ops, slstm_scan_ref

    ins = _slstm_inputs(gen, *case)
    want = ops.plan(case[3]) if variant == "planned" else "fma"

    def call():
        if variant == "planned":
            return slstm_scan(*ins)
        return ops._forward(*ins, force_fma=True)[:4]

    before = dict(slstm_scan.variants)
    got = call()
    assert slstm_scan.variants == dict(before, **{want: before[want] + 1})
    for g, w in zip(got, slstm_scan_ref(*ins)):
        _close_rel(g, w, SLSTM_TOL)
    again = call()
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("case", _SLSTM_CASES)
@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("variant", ["planned", "fma"])
def test_slstm_scan_bwd_kernel(gen, case, with_final, variant):
    """The Function's forward (the kernel, storing c, n, z) and backward
    (the backward kernel, dr by slstm_dr) against autograd of the loop;
    ``fma`` forced on both kernels, with the same dr, beside it."""
    from repro_torch.kernels import slstm_scan, slstm_scan_bwd
    from repro_torch.kernels.slstm import ops, slstm_dr, slstm_scan_ref

    ins = _slstm_inputs(gen, *case)
    b, s, h, d, _ = case
    dys = torch.randn(b, s, h * d, generator=gen, device="cuda")
    d_final = ([torch.randn(b, h * d, generator=gen, device="cuda"),
                torch.randn(b, h, generator=gen, device="cuda"),
                torch.randn(b, h * d, generator=gen, device="cuda")] if with_final else [])
    want = ops.plan(d) if variant == "planned" else "fma"

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        outs = fn(*leaves)
        torch.autograd.backward(list(outs[:1 + len(d_final)]), [dys] + d_final)
        return [t.grad for t in leaves]

    def kernels():
        if variant == "planned":
            return grads(slstm_scan)
        i_in, f_in, o_in, r, c0, n0, h0 = ins[1:]
        ys, _, _, _, saved = ops._forward(*ins, store=True, force_fma=True)
        dz, di, df, do, dc0, dn0, dh0 = ops._backward(i_in, f_in, o_in, r, c0, n0, saved, dys,
                                                      *(d_final or [None] * 3), force_fma=True)
        return [dz, di, df, do, slstm_dr(h0, ys, dz, h), dc0, dn0, dh0]

    before = (dict(slstm_scan.variants), dict(slstm_scan_bwd.variants))
    got = kernels()
    assert slstm_scan.variants == dict(before[0], **{want: before[0][want] + 1})
    assert slstm_scan_bwd.variants == dict(before[1], **{want: before[1][want] + 1})
    for g, w in zip(got, grads(slstm_scan_ref)):
        _close_rel(g, w, SLSTM_TOL)
    again = kernels()
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_kernels_launch_from_a_fresh_thread_after_the_main_thread(gen):
    """A launch that is the first CUDA call of its host thread (autograd's
    backward thread, say) after another thread has launched the same
    kernel: each launcher raises its shared-memory cap once per thread."""
    import threading

    a = torch.randn(512, 2560, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(5120, 2560, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    u, ld, B, C = _ssm_inputs(gen, 2, 128, 8, 64, 64, torch.bfloat16, True)
    calls = {"dos_matmul": lambda: dos_matmul(a, w.T),
             "flash_attention": lambda: flash_attention(q, k, v),
             "ssm_scan": lambda: ssm_scan(u, ld, B, C)[0]}
    want = {name: fn() for name, fn in calls.items()}
    got, errors = {}, {}

    def run():
        for name, fn in calls.items():
            try:
                got[name] = fn()
            except RuntimeError as e:
                errors[name] = str(e)
        torch.cuda.synchronize()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not errors
    for name in calls:
        assert torch.equal(got[name], want[name]), name


# The grouped GEMM (grouped_matmul, grouped_matmul_dw) against its plain
# version on the f32 result of the same operands: f32, 1e-5 of max|ref|
# (summation order); a bf16 output, one bf16 rounding (2**-8) of each
# entry more. An f32 dw: 1e-5 of max|ref|; a bf16 dw is the f32 dw of the
# same variant rounded once, bit for bit. Every variant the operands
# allow (wgmma at each block height, fma) is forced on the same inputs
# beside the one the plan picks.
_GMM_CASES = [  # rows, K, N, sizes
    (24, 2048, 1408, [1, 0, 2, 0, 3, 0, 0, 1] * 3),   # decode-like, empty groups
    (300, 200, 136, [0, 300, 0]),                      # one group holds every row
    (130, 96, 72, [17, 0, 40, 3]),                     # rows past the sum (60 of 130)
    (257, 1000, 520, [64, 1, 0, 100, 92]),             # ragged K and N
    (1200, 256, 512, [300, 0, 517, 383]),              # training-like: 128-row tiles, N % 256 = 0
    (700, 136, 200, [130, 250, 0, 320]),               # ragged last k stage and n tile
    (900, 128, 320, [300, 200, 0, 400]),               # a ragged last column tile
]


def _gmm_inputs(gen, rows, k, n, sizes, dtype, transposed):
    x = torch.randn(rows, k, generator=gen, device="cuda").to(dtype)
    w = torch.randn(len(sizes), n, k, generator=gen, device="cuda").to(dtype) / k**0.5
    w = w.transpose(-1, -2) if transposed else w.reshape(len(sizes), k, n)
    return x, w, torch.tensor(sizes, dtype=torch.int32, device="cuda")


def _gmm_variants(dtype):
    """(variant, block rows; 0: the plan's) of every variant bf16 or f32
    operands with 16-byte rows allow."""
    if dtype == torch.float32:
        return [("fma", 0)]
    return [("wgmma", 64), ("wgmma", 128), ("fma", 0)]


@pytest.mark.parametrize("case", _GMM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transposed", [False, True])
def test_grouped_matmul_kernel(gen, case, dtype, transposed):
    from repro_torch.kernels import grouped_matmul
    from repro_torch.kernels.grouped_matmul import grouped_matmul_ref
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops

    rows, k, n, sizes = case
    x, w, gs = _gmm_inputs(gen, rows, k, n, sizes, dtype, transposed)
    want = gmm_ops.plan(rows, len(sizes), dtype, True).variant
    before = dict(grouped_matmul.variants)
    out = grouped_matmul(x, w, gs)
    assert grouped_matmul.variants == dict(before, **{want: before[want] + 1})
    exact = grouped_matmul_ref(x.float(), w.float(), gs)
    tol = 1e-5 * exact.abs().max() + (2.0**-8 * exact.abs() if dtype == torch.bfloat16 else 0)
    for variant, bm in [(None, 0)] + _gmm_variants(dtype):
        got = out if variant is None else gmm_ops._launch_forward(x, w, gs, force=variant, bm=bm)
        assert got.dtype == dtype
        assert bool(((got.float() - exact).abs() <= tol).all()), (variant, bm)
        assert not got[sum(sizes):].any(), (variant, bm)
        assert torch.equal(got, gmm_ops._launch_forward(x, w, gs, force=variant, bm=bm))


@pytest.mark.parametrize("case", _GMM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_dw_kernel(gen, case, dtype):
    from repro_torch.kernels import grouped_matmul_dw
    from repro_torch.kernels.grouped_matmul import grouped_matmul_dw_ref
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops

    rows, k, n, sizes = case
    x, _, gs = _gmm_inputs(gen, rows, k, n, sizes, dtype, False)
    dy = torch.randn(rows, n, generator=gen, device="cuda").to(dtype)
    before = dict(grouped_matmul_dw.variants)
    dw = grouped_matmul_dw(x, dy, gs)
    want = gmm_ops.dw_plan(dtype, True)
    assert grouped_matmul_dw.variants == dict(before, **{want: before[want] + 1})
    exact = grouped_matmul_dw_ref(x, dy, gs)
    assert dw.dtype == torch.float32
    for variant in (None,) + gmm_ops.VARIANTS if dtype == torch.bfloat16 else (None, "fma"):
        got = dw if variant is None else gmm_ops._launch_dw(x, dy, gs, force=variant)
        assert bool(((got - exact).abs() <= 1e-5 * exact.abs().max()).all()), variant
        for g, s in enumerate(sizes):
            if s == 0:
                assert not got[g].any(), variant
        assert torch.equal(got, gmm_ops._launch_dw(x, dy, gs, force=variant))
        low = gmm_ops._launch_dw(x, dy, gs, force=variant, out_dtype=torch.bfloat16)
        assert low.dtype == torch.bfloat16 and torch.equal(low, got.to(torch.bfloat16)), variant


@pytest.mark.parametrize("case", _GMM_CASES)
@pytest.mark.parametrize("transposed", [False, True])
def test_grouped_matmul_f32_output(gen, case, transposed):
    """The f32 output a mesh's K-split and row-parallel partials take:
    every variant the bf16 operands allow within 1e-5 of max|ref| of the
    plain version, rows past the sum zero, and rounded to bf16 bit for bit
    the same variant's bf16 output (the same f32 accumulators, rounded
    once); through the wrapper the variant its plan picks."""
    from repro_torch.kernels import grouped_matmul
    from repro_torch.kernels.grouped_matmul import grouped_matmul_ref
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops

    rows, k, n, sizes = case
    x, w, gs = _gmm_inputs(gen, rows, k, n, sizes, torch.bfloat16, transposed)
    want = gmm_ops.plan(rows, len(sizes), torch.bfloat16, True).variant
    before = dict(grouped_matmul.variants)
    out = grouped_matmul(x, w, gs, out_dtype=torch.float32)
    assert grouped_matmul.variants == dict(before, **{want: before[want] + 1})
    exact = grouped_matmul_ref(x.float(), w.float(), gs)
    for variant, bm in [(None, 0)] + _gmm_variants(torch.bfloat16):
        f = dict(force=variant, bm=bm)
        got = out if variant is None else gmm_ops._launch_forward(x, w, gs, out_dtype=torch.float32,
                                                                  **f)
        assert got.dtype == torch.float32
        assert bool(((got - exact).abs() <= 1e-5 * exact.abs().max()).all()), (variant, bm)
        assert not got[sum(sizes):].any(), (variant, bm)
        low = gmm_ops._launch_forward(x, w, gs, **(f if variant else dict(force=want)))
        assert torch.equal(got.to(torch.bfloat16), low), (variant, bm)


def test_grouped_matmul_function_gradients(gen):
    """dX through the forward kernel on w's transposed view, dW through
    grouped_matmul_dw, against autograd of the plain version."""
    from repro_torch.kernels import grouped_matmul, grouped_matmul_dw
    from repro_torch.kernels.grouped_matmul import grouped_matmul_ref

    x, w, gs = _gmm_inputs(gen, 384, 256, 192, [100, 0, 200, 84], torch.bfloat16, False)
    dy = torch.randn(384, 192, generator=gen, device="cuda").to(torch.bfloat16)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = (grouped_matmul.launches, grouped_matmul_dw.launches)
    grouped_matmul(xg, wg, gs).backward(dy)
    assert (grouped_matmul.launches, grouped_matmul_dw.launches) == (before[0] + 2,
                                                                      before[1] + 1)
    xr, wr = x.float().requires_grad_(), w.float().requires_grad_()
    grouped_matmul_ref(xr, wr, gs).backward(dy.float())
    for got, want in ((xg.grad, xr.grad), (wg.grad, wr.grad)):
        tol = 1e-5 * want.abs().max() + 2.0**-8 * want.abs()
        assert bool(((got.float() - want).abs() <= tol).all())


def test_vlm_with_image_embeds_off_the_compute_dtype_matches_the_cpu(gen):
    """bf16 compute with f32 image embeddings: the reference projects the
    cross k, v in f32 and attends its bf16 q to them (tests/test_torch_vlm.py
    pins that on the CPU). The card's flash wrapper promotes q, k, v to
    f32, runs the kernel in f32 and returns bf16, as the CPU path does: the
    prefill's logits within the bf16 band, 3e-2 of max|logits|, of the
    CPU's, the vision gates opened to 0.5 (at their init of 0 no
    cross-attention result reaches the logits)."""
    cfg = dataclasses.replace(reduced(get_config("llama-3.2-vision-11b")),
                              compute_dtype="bfloat16")
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    img = torch.randn(2, cfg.n_image_tokens, cfg.d_model,
                      generator=torch.Generator().manual_seed(2))
    logits = {}
    for dev in ("cpu", "cuda"):
        model = build(cfg, device=dev)
        params = model.init_compute(torch.Generator().manual_seed(0))
        params["cross_layers"]["gate"].fill_(0.5)
        logits[dev], cache = model.prefill(params, {"tokens": tokens, "image_embeds": img})
        assert logits[dev].dtype == torch.float32 and cache["cross"]["k"].dtype == torch.float32
    want = logits["cpu"]
    assert (logits["cuda"].cpu() - want).abs().max() <= 3e-2 * want.abs().max()


def test_a_cuda_tensor_launches_where_a_meta_tensor_is_charged(gen):
    """The wrappers' meta branch (the dry-run's accounting) is for meta
    tensors only: a CUDA call inside the accounting launches its kernel
    (the wrapper's counters move, nothing is charged, the result agrees
    with the plain version's at phase 4's gate); the same call on meta
    tensors of the same shapes plans the same variant and is charged and
    counted by the accounting instead, the wrapper's counters unmoved."""
    from repro_torch.launch.accounting import Accounting

    a = torch.randn(64, 32, generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn(32, 48, generator=gen, device="cuda").to(torch.bfloat16)
    before = dict(dos_matmul.variants)
    with Accounting() as acc:
        out = dos_matmul(a, b)
    torch.cuda.synchronize()
    launched = {v: n - before[v] for v, n in dos_matmul.variants.items() if n != before[v]}
    assert launched == {"wgmma": 1} and acc.launches == {} and acc.kernels == {}
    exact = matmul_ref(a, b, torch.float32)  # phase 4's gate: f32 order, one bf16 rounding
    assert ((out.float() - exact).abs() <= 2.0**-8 * exact.abs() + 1e-5 * exact.abs().max()).all()
    before = dict(dos_matmul.variants)
    with Accounting() as meta:
        dos_matmul(a.to("meta"), b.to("meta"))
    assert dos_matmul.variants == before
    assert meta.launches == {"dos_matmul": launched}
    assert meta.kernels["dos_matmul"]["flops"] == 2 * 64 * 32 * 48


# --- AdamW and decode attention ---------------------------------------------------------------
#
# The AdamW update against adamw_ref on the same card, bit for bit (the
# kernel rounds every product and sum on its own, as torch's separate ops
# do). The sum of squares: the same bits on every run, and within 1e-5 of
# an f64 sum in f32 (another order). Decode attention against the f32
# result of its own semantics on the same operands (q' rounded to q's
# dtype, f32 scores and sums, p unrounded): 1e-5 absolute (phase 4's flash
# gate) plus, for a bf16 output, one bf16 rounding of each entry; a row
# with no visible slot exact zeros and lse -inf.


def _adamw_operands(gen, shape, gdtype, layout):
    """p, g, m, v of ``shape`` (v positive) in ``layout``: contiguous, one
    element off 16 bytes (flat, unvectorised) or transposed (strided)."""
    def make(positive=False, dtype=torch.float32):
        n = int(torch.tensor(shape).prod())
        x = torch.randn(n + 1, generator=gen, device="cuda")
        x = (x.abs() if positive else x).to(dtype)
        if layout == "offset":
            return x[1:].view(shape)
        if layout == "transposed":
            return x[:n].view(shape[::-1]).transpose(0, -1)
        return x[:n].view(shape)
    return make(), make(dtype=gdtype), make(), make(positive=True)


@pytest.mark.parametrize("shape", [(1,), (1001,), (577, 96), (3, 64, 129)])
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "offset", "transposed"])
def test_adamw_kernel_is_bit_identical_to_plain(gen, shape, gdtype, layout):
    from repro_torch.kernels import adamw
    from repro_torch.kernels.adamw import adamw_ref

    if layout == "transposed" and len(shape) == 1:
        pytest.skip("a 1-d tensor has no transposed view")
    p, g, m, v = _adamw_operands(gen, shape, gdtype, layout)
    scalars = [torch.rand((), generator=gen, device="cuda") * 0.9 + 0.1 for _ in range(4)]
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    want = [t.clone() for t in (p, m, v)]
    adamw_ref(want[0], g, want[1], want[2], *scalars, **kw)
    before = dict(adamw.variants)
    adamw(p, g, m, v, *scalars, **kw)
    torch.cuda.synchronize()
    assert adamw.variants["update"] == before["update"] + 1
    for got, w in zip((p, m, v), want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("n", [0, 1, 4097, 3 * 2**20 + 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sum_squares_kernel_is_deterministic(gen, n, dtype):
    from repro_torch.kernels.adamw import sum_squares

    xs = [torch.randn(n, generator=gen, device="cuda").to(dtype),
          torch.randn(n + 7, generator=gen, device="cuda").to(dtype)[7:],
          torch.randn(max(n, 2) // 2, 2, generator=gen, device="cuda").to(dtype).T]
    got = sum_squares(xs)
    assert torch.equal(got, sum_squares(xs))
    want = torch.stack([x.double().square().sum() for x in xs]).float()
    assert torch.allclose(got, want, rtol=1e-5, atol=0)
    big = torch.full((1000,), 1e20, device="cuda", dtype=dtype)  # squares overflow f32
    assert sum_squares([big]).item() == float("inf")


def _decode_exact(q, kc, vc, length, window, scale):
    """The f32 result of the kernel's semantics on the same operands."""
    from repro_torch.kernels.flash_attention import decode_attention_ref

    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    qr = (q.float() * scale).to(q.dtype).float()
    length = length.cpu() if isinstance(length, torch.Tensor) else length
    return decode_attention_ref(qr.cpu(), kc.float().cpu(), vc.float().cpu(), length=length,
                                window=window, scale=1.0, return_lse=True)


_DECODE_CASES = [  # b, s, h, kvh, d, length, window
    (4, 160, 9, 3, 64, 131, None), (4, 1500, 16, 16, 64, 1500, None),
    (4, 1600, 32, 8, 128, 1600, None), (2, 300, 32, 32, 80, [300, 0], None),
    (3, 513, 4, 1, 256, [513, 7, 200], 64), (2, 40, 8, 1, 32, 40, 0),
    (2, 200, 40, 8, 128, [1, 199], 24)]


@pytest.mark.parametrize("case", _DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("return_lse", [False, True])
def test_decode_attention_kernel(gen, case, dtype, return_lse):
    from repro_torch.kernels import decode_attention

    b, s, h, kvh, d, length, window = case
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(b, s, kvh, d, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(b, s, kvh, d, generator=gen, device="cuda").to(dtype)
    if isinstance(length, list):
        length = torch.tensor(length, device="cuda")
    before = decode_attention.launches
    got = decode_attention(q, kc, vc, length=length, window=window, return_lse=return_lse)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    o, lse = got if return_lse else (got, None)
    exact_o, exact_lse = _decode_exact(q, kc, vc, length, window, None)
    exact_o = exact_o.to(o.device)
    assert o.dtype == (torch.float32 if return_lse else dtype) and o.shape == q.shape
    tol = 1e-5 + (2.0**-8 * exact_o.abs() if o.dtype == torch.bfloat16 else 0)
    assert bool(((o.float() - exact_o).abs() <= tol).all())
    dead = torch.isinf(exact_lse).to(o.device)  # rows with no visible slot: exact zeros
    assert bool((o.float()[dead] == 0).all())
    if return_lse:
        exact_lse = exact_lse.to(o.device)
        assert bool((lse[dead] == -math.inf).all())
        live = ~dead
        assert bool(((lse - exact_lse)[live].abs() <= 1e-5 * exact_lse[live].abs().clamp(min=1))
                    .all())


def test_decode_attention_kernel_takes_strided_and_mixed_operands(gen):
    """A rank's slice of the slots and a layer of a stacked cross cache (views
    of larger tensors), and a bf16 q over an f32 cache (the vision model
    with f32 image embeddings), read as they are; a per-batch length off
    the card raises instead of being copied."""
    from repro_torch.kernels import decode_attention

    full = torch.randn(2, 3, 256, 8, 128, generator=gen, device="cuda")
    kc, vc = full[1, :, 64:], full[0, :, 64:]  # strided, not contiguous
    q = torch.randn(3, 1, 32, 128, generator=gen, device="cuda").to(torch.bfloat16)
    got = decode_attention(q, kc, vc, length=150, window=None)
    exact, _ = _decode_exact(q, kc, vc, 150, None, None)
    exact = exact.to(got.device)
    assert got.dtype == torch.bfloat16
    assert bool(((got.float() - exact).abs() <= 1e-5 + 2.0**-8 * exact.abs()).all())
    with pytest.raises(ValueError, match="lengths on cpu"):
        decode_attention(q, kc, vc, length=torch.tensor([1, 2, 3]))
