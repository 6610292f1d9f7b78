"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: without a card each test skips. Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32, 1e-5 of max|ref| for the matmul (summation order) and
1e-5 absolute for attention (f32 math on both sides, O(1) outputs);
bf16 output, one bf16 rounding more: 2**-8 of each entry, measured
against the f32 result of the same bf16 operands. The SSD scan: 1e-4 of
max|ref| in f32 (summation order over T*N terms, and the chunk's
cumulative log-decay summed in another order inside the exp), plus
2**-8 of each entry of a bf16 y.
"""

import pytest
import torch

from repro_torch.kernels import dos_matmul, flash_attention, ssm_scan
from repro_torch.kernels.dos_matmul import matmul_ref
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.ssm_scan import CHUNKS, ssm_scan_chunked

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


def test_ssm_scan_rejects_unbuilt_state_dims(gen):
    u, ld, B, C = _ssm_inputs(gen, 1, 8, 2, 8, 24, torch.float32, False)
    with pytest.raises(ValueError, match="state dim"):
        ssm_scan(u, ld, B, C)
