"""The ssm_scan planner (``repro_torch.kernels.ssm_scan.plan``) and a
plain-torch emulation of its ``mma`` variant's numerics, on the CPU.

The planner picks the CUDA kernel from dtype, state dim, chunk and layout
alone: ``mma`` for bf16 u, B, C with a unit inner stride, their other
strides multiples of 8 elements (0 included: B, C broadcast over the
heads) and 16-byte aligned bases, and P a multiple of 8; ``fma`` for f32
and for bf16 layouts ``mma`` cannot take; it raises for what neither
takes.

The emulation repeats the ``mma`` kernel's arithmetic (``csrc/ssm_scan.cu``)
chunk by chunk: la = cumsum(ld); y = diag(exp la) (C S_prev) + G U with
G = (C B^T) o exp(la_i - la_j) masked before the exp; S = exp(la_T) S +
(U o exp(la_T - la_t))^T B; every product of bf16 operands summed in f32,
and the operands the reference holds in f32 (S_prev, G, the decayed U)
split into two bf16 terms whose products are summed in f32. It is held,
at the card check's own tolerance (``chip_smoke.py`` ``check_ssm``: y
within 1e-4 of max|ref| plus 2**-8 of each bf16 entry, the state within
1e-4 of max|ref|), against the port's ``ssm_scan_chunked`` and the JAX
package's ``ssm_scan_chunked_jnp``, at reduced widths and at zamba2's
head (N = P = 64, S 128, chunks 32 and 64). One term misses the gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssm_scan.ops import ssm_scan_chunked_jnp
from repro_torch.kernels.ssm_scan import CHUNKS, STATE_DIMS, VARIANTS, plan, ssm_scan_chunked

BF16, F32 = torch.bfloat16, torch.float32


def _contig(bt, s, h, x):
    return (s * h * x, h * x, x, 1)


def _bcast(bt, s, n):  # one B, C per step, expanded over the heads
    return (s * n, n, 0, 1)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", STATE_DIMS)
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype,want", [(BF16, "mma"), (F32, "fma")])
def test_contiguous_inputs_plan_by_dtype(n, chunk, dtype, want):
    st = (_contig(2, 128, 8, 64), _contig(2, 128, 8, n), _contig(2, 128, 8, n))
    assert plan(dtype, n, chunk, 64, st, True) == want


@pytest.mark.parametrize("chunk", CHUNKS)
def test_zamba2_prefill_layout_plans_to_mma(chunk):
    """Mamba2's u (Bt, S, H, P) and B, C expanded over the 80 heads (head
    stride 0), bf16: the serving path's scan."""
    st = (_contig(4, 128, 80, 64), _bcast(4, 128, 64), _bcast(4, 128, 64))
    assert plan(BF16, 64, chunk, 64, st, True) == "mma"


@pytest.mark.parametrize("p", [8, 40, 192])
def test_p_multiple_of_eight_plans_to_mma(p):
    st = (_contig(1, 64, 2, p), _contig(1, 64, 2, 64), _contig(1, 64, 2, 64))
    assert plan(BF16, 64, 32, p, st, True) == "mma"


@pytest.mark.parametrize("p", [1, 12, 100])
def test_p_off_multiples_of_eight_plans_to_fma(p):
    """y's rows (contiguous, P apart) would not start on 16 bytes."""
    st = (_contig(1, 64, 2, p), _contig(1, 64, 2, 64), _contig(1, 64, 2, 64))
    assert plan(BF16, 64, 32, p, st, True) == "fma"


def test_misaligned_base_plans_to_fma():
    st = (_contig(2, 64, 4, 64), _bcast(2, 64, 64), _bcast(2, 64, 64))
    assert plan(BF16, 64, 32, 64, st, False) == "fma"


@pytest.mark.parametrize("which", [0, 1, 2])
def test_non_unit_inner_stride_plans_to_fma(which):
    st = [_contig(2, 64, 4, 64), _contig(2, 64, 4, 64), _contig(2, 64, 4, 64)]
    b, s, h, _ = st[which]
    st[which] = (2 * b, 2 * s, 2 * h, 2)
    assert plan(BF16, 64, 32, 64, tuple(st), True) == "fma"


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_strides_off_multiples_of_eight_plan_to_fma(which, axis):
    st = [list(_contig(2, 64, 4, 64)) for _ in range(3)]
    st[which][axis] += 4
    assert plan(BF16, 64, 32, 64, tuple(map(tuple, st)), True) == "fma"


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_unbuilt_dtypes_raise(dtype):
    st = (_contig(1, 8, 2, 64),) * 3
    with pytest.raises(TypeError):
        plan(dtype, 64, 32, 64, st, True)


@pytest.mark.parametrize("n,chunk", [(48, 32), (128, 32), (64, 16), (64, 128)])
def test_unbuilt_state_dims_and_chunks_raise(n, chunk):
    st = (_contig(1, 8, 2, 64), _contig(1, 8, 2, n), _contig(1, 8, 2, n))
    with pytest.raises(ValueError, match="state dim"):
        plan(BF16, n, chunk, 64, st, True)


def test_wrapper_counts_variants_only_on_the_card():
    """On the CPU the wrapper runs its plain version and launches nothing."""
    from repro_torch.kernels.ssm_scan import ssm_scan

    assert tuple(ssm_scan.variants) == VARIANTS
    before = dict(ssm_scan.variants)
    u = torch.randn(1, 8, 2, 8, dtype=BF16)
    B = torch.randn(1, 8, 2, 16, dtype=BF16)
    ssm_scan(u, -torch.rand(1, 8, 2), B, B)
    assert ssm_scan.variants == before


# ---------------------------------------------------------------------------
# the mma variant's numerics, emulated in plain torch
# ---------------------------------------------------------------------------


def split_bf16(x, terms):
    """x (f32) as ``terms`` bf16 tensors whose sum it is (the kernel's
    ``split_bf16``), each returned in f32."""
    parts = []
    for _ in range(terms):
        part = x.to(BF16).float()
        parts.append(part)
        x = x - part
    return parts


def ssm_mma_emulation(u, ld, B, C, chunk, terms=2):
    """The mma kernel's arithmetic on bf16 u, B, C and f32 ld: returns the
    f32 y before its rounding to bf16, and the f32 state."""
    bt, s, h, p = u.shape
    n = B.shape[-1]
    pad = -s % chunk  # identity steps: ld = 0, u = B = C = 0
    uf, Bf, Cf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)) for t in (u, B, C))
    ldf = F.pad(ld.float(), (0, 0, 0, pad))
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    state = torch.zeros(bt, h, n, p)
    ys = []
    for c0 in range(0, s + pad, chunk):
        U, Bc, Cc = (t[:, c0:c0 + chunk].permute(0, 2, 1, 3) for t in (uf, Bf, Cf))  # (bt, h, T, x)
        la = torch.cumsum(ldf[:, c0:c0 + chunk].permute(0, 2, 1), -1)  # (bt, h, T)
        la_T = la[..., -1:]
        y = torch.zeros(bt, h, chunk, p)
        if c0:
            y = sum(Cc @ part for part in reversed(split_bf16(state, terms))) * torch.exp(la)[..., None]
        G = (Cc @ Bc.transpose(-1, -2)) * torch.exp(
            torch.where(tri, la[..., :, None] - la[..., None, :], -float("inf")))
        y = y + sum(part @ U for part in reversed(split_bf16(G, terms)))
        ys.append(y)
        ud = U * torch.exp(la_T - la)[..., None]
        state = torch.exp(la_T)[..., None] * state + sum(
            Bc.transpose(-1, -2) @ part for part in reversed(split_bf16(ud, terms)))
    return torch.cat(ys, 2).permute(0, 2, 1, 3)[:, :s], state


def _inputs(bt, s, h, p, n, seed, shared):
    """bf16 u, B, C and f32 ld = dt * A as Mamba2 makes them (dt =
    softplus(normal), A = -[1..H]), from numpy."""
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.standard_normal((bt, s, h, p), dtype=np.float32)).to(BF16)
    dt = F.softplus(torch.from_numpy(rng.standard_normal((bt, s, h), dtype=np.float32)))
    ld = -dt * torch.arange(1, h + 1, dtype=F32)
    nb = 1 if shared else h
    B, C = (torch.from_numpy(rng.standard_normal((bt, s, nb, n), dtype=np.float32)).to(BF16)
            .expand(bt, s, h, n) for _ in range(2))
    return u, ld, B, C


def _within_gate(y, state, ey, est):
    """chip_smoke.py's check_ssm on a bf16 y."""
    yerr = (y.to(BF16).float() - ey).abs()
    ok_y = bool((yerr <= 1e-4 * ey.abs().max() + 2.0**-8 * ey.abs()).all())
    return ok_y and bool(((state - est).abs() <= 1e-4 * est.abs().max()).all())


# bt, s, h, p, n, B/C broadcast over the heads
EMU_CASES = {
    "zamba2 heads, N = P = 64, S 128": (1, 128, 3, 64, 64, True),
    "ragged S, N 16": (2, 100, 4, 16, 16, False),
    "S below the chunk": (1, 20, 2, 64, 64, False),
    "many chunks": (1, 320, 2, 32, 64, True),
    "N 96, P 40": (1, 72, 2, 40, 96, False),
}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", list(EMU_CASES))
def test_mma_emulation_meets_the_gate_against_the_plain_scan(case, chunk):
    u, ld, B, C = _inputs(*EMU_CASES[case][:5], seed=7, shared=EMU_CASES[case][5])
    ey, est = ssm_scan_chunked(u.float(), ld, B.float(), C.float(), chunk)
    assert _within_gate(*ssm_mma_emulation(u, ld, B, C, chunk), ey, est)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", ["zamba2 heads, N = P = 64, S 128", "many chunks"])
def test_mma_emulation_meets_the_gate_against_the_jax_package(case, chunk):
    """S is a multiple of the chunk here: the JAX twin does not pad."""
    u, ld, B, C = _inputs(*EMU_CASES[case][:5], seed=11, shared=EMU_CASES[case][5])
    ry, rs = ssm_scan_chunked_jnp(*(jnp.asarray(t.float().contiguous().numpy())
                                    for t in (u, ld, B, C)), chunk=chunk)
    ey, est = torch.from_numpy(np.array(ry)), torch.from_numpy(np.array(rs))
    assert _within_gate(*ssm_mma_emulation(u, ld, B, C, chunk), ey, est)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_one_term_misses_the_gate(chunk):
    """S_prev, G and the decayed U rounded to bf16 once (one term) miss the
    gate at zamba2's head; two terms leave 2**-16 of each value and meet
    it with room (the kernel runs two)."""
    u, ld, B, C = _inputs(1, 128, 3, 64, 64, seed=5, shared=True)
    ey, est = ssm_scan_chunked(u.float(), ld, B.float(), C.float(), chunk)
    assert not _within_gate(*ssm_mma_emulation(u, ld, B, C, chunk, terms=1), ey, est)
    y, state = ssm_mma_emulation(u, ld, B, C, chunk, terms=2)
    assert (y - ey).abs().max() <= 1e-5 * ey.abs().max()
    assert (state - est).abs().max() <= 1e-5 * est.abs().max()
