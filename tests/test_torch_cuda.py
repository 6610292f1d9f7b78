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
"""

import pytest
import torch

from repro_torch.kernels import dos_matmul, flash_attention, ssm_scan
from repro_torch.kernels.dos_matmul import matmul_ref, plan
from repro_torch.kernels.flash_attention import HEAD_DIMS, attention_ref
from repro_torch.kernels.ssm_scan import CHUNKS, STATE_DIMS, ssm_scan_chunked

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


def test_ssm_scan_rejects_unbuilt_state_dims(gen):
    u, ld, B, C = _ssm_inputs(gen, 1, 8, 2, 8, 24, torch.float32, False)
    with pytest.raises(ValueError, match="state dim"):
        ssm_scan(u, ld, B, C)
