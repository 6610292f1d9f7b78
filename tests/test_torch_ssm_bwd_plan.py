"""The ssm_scan backward's planner and a plain-torch emulation of its
``mma`` variant's numerics, on the CPU.

``ssm_scan_bwd`` on the card runs ``plan`` (the forward's) over u, dy, B
and C: ``mma`` for bf16 operands with a unit inner stride, their other
strides multiples of 8 elements (0 included: B, C shared by the heads)
and 16-byte aligned bases, and P a multiple of 8 (the last 64-column tile
may be ragged); ``fma`` for f32 and for other bf16 layouts. With B and C
shared, ``mma`` sums the heads' dB and dC on chip in groups of up to 8
heads (``head_group``).

The emulation repeats the ``mma`` kernel's arithmetic (``csrc/
ssm_scan_bwd.cu``) chunk by chunk in reverse: la = cumsum(ld); G = (C B^T)
o L and A = (dy u^T) o L with L masked before the exp; du = G^T dy +
exp(la_T - la_j) B dS; dB = A^T C + exp(la_T - la_j) u dS^T; dC = A B +
exp(la_i) dy S_c^T; dS <- exp(la_T) dS + C^T (dy o exp(la)); d(la) from
the row and column sums of G o (dy u^T), C_i.(dC's state term), B_j.(dB's
state term) and <dS, S_c>, and dld its reverse cumsum. bf16 operands (u,
dy, B, C) are exact; those the reference holds in f32 (G, A, dS, S_c and
dy o exp(la)) are split into the kernel's ``B_TERMS`` bf16 terms whose
products sum in f32. The states are the f32 states of the same operands.

Held at the card's gate (``chip_smoke.py`` ``SSM_BWD_TOL``: bf16, 1e-3
of each gradient's max|ref| plus one bf16 rounding, 2**-8, of each du,
dB and dC entry) against ``ssm_scan_bwd_ref`` and ``jax.grad`` of the
JAX package's ``ssm_scan_chunked_jnp``, at zamba2's head (N = P = 64, S
128, chunks 32 and 64) and at the edge shapes ``chip_smoke.py`` runs on
the card. With Mamba2's light decays (dt up to 0.1, its ``dt_max``), one
term of any of the five split operands misses the gate.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssm_scan.ops import ssm_scan_chunked_jnp
from repro_torch.kernels.ssm_scan import CHUNKS, VARIANTS, plan, ssm_scan_bwd, ssm_scan_bwd_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan.ref import _chunks

BF16, F32 = torch.bfloat16, torch.float32
SPLIT = ("G", "A", "dS", "S_c", "dy_ein")  # the operands the kernel splits


def _contig(s, h, x):
    return (s * h * x, h * x, x, 1)


def _shared(s, n):  # Mamba2's B, C: (Bt, S, 1, N) expanded over the heads
    return (s * n, n, 0, 1)


def _strides(s, h, p, n, shared=True):
    bc = _shared(s, n) if shared else _contig(s, h, n)
    return (_contig(s, h, p), _contig(s, h, p), bc, bc)  # u, dy, B, C


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", CHUNKS)
def test_zamba2_training_layout_plans_to_mma(chunk):
    """zamba2-2.7b's training scan: u, dy (8, 512, 80, 64) and B, C
    ``Bm[:, :, None, :]`` expanded over the 80 heads (head stride 0), bf16."""
    assert plan(BF16, 64, chunk, 64, _strides(512, 80, 64, 64), True) == "mma"


@pytest.mark.parametrize("n", [16, 32, 64, 96])
@pytest.mark.parametrize("p", [8, 40, 192])
def test_p_multiple_of_eight_plans_to_mma(n, p):
    """P = 40 is one ragged 64-column tile, P = 192 three."""
    assert plan(BF16, n, 32, p, _strides(100, 3, p, n, shared=False), True) == "mma"


@pytest.mark.parametrize("p", [1, 12, 100])
def test_p_off_multiples_of_eight_plans_to_fma(p):
    assert plan(BF16, 96, 32, p, _strides(33, 2, p, 96, shared=False), True) == "fma"


@pytest.mark.parametrize("chunk", CHUNKS)
def test_f32_plans_to_fma(chunk):
    assert plan(F32, 64, chunk, 64, _strides(512, 80, 64, 64), True) == "fma"


def test_misaligned_base_plans_to_fma():
    assert plan(BF16, 64, 32, 64, _strides(512, 80, 64, 64), False) == "fma"


@pytest.mark.parametrize("which", ["u", "dy", "B", "C"])
def test_non_unit_inner_stride_plans_to_fma(which):
    st = list(_strides(128, 4, 64, 64, shared=False))
    i = ["u", "dy", "B", "C"].index(which)
    st[i] = tuple(2 * x for x in st[i])
    assert plan(BF16, 64, 32, 64, tuple(st), True) == "fma"


@pytest.mark.parametrize("which", ["u", "dy", "B", "C"])
def test_row_strides_off_multiples_of_eight_plan_to_fma(which):
    st = [list(x) for x in _strides(128, 4, 64, 64, shared=False)]
    st[["u", "dy", "B", "C"].index(which)][1] += 4
    assert plan(BF16, 64, 32, 64, tuple(map(tuple, st)), True) == "fma"


@pytest.mark.parametrize("h,shared,variant,most,want", [
    (80, True, "mma", 8, 8),    # zamba2: 10 partials of 8 heads each
    (12, True, "mma", 8, 4),
    (6, True, "mma", 8, 2),
    (3, True, "mma", 8, 1),
    (80, True, "mma", 1, 1),    # T 64, N 96: a cluster's slices do not fit
    (80, False, "mma", 8, 1),   # per-head B, C: per-head gradients
    (80, True, "fma", 8, 1),    # fma writes per head; the wrapper sums
])
def test_head_group(h, shared, variant, most, want):
    assert ssm_ops.head_group(h, shared, variant, most) == want


def test_wrapper_counts_variants_only_on_the_card():
    """On the CPU the wrapper runs ssm_scan_bwd_ref and launches nothing."""
    assert tuple(ssm_scan_bwd.variants) == VARIANTS
    before = (ssm_scan_bwd.launches, dict(ssm_scan_bwd.variants))
    u = torch.randn(1, 40, 2, 8, dtype=BF16)
    B = torch.randn(1, 40, 1, 16, dtype=BF16)
    got = ssm_scan_bwd(u, -torch.rand(1, 40, 2), B, B, torch.ones_like(u))
    assert (ssm_scan_bwd.launches, ssm_scan_bwd.variants) == before
    assert [g.dtype for g in got] == [BF16, F32, BF16, BF16]


# ---------------------------------------------------------------------------
# the mma variant's numerics, emulated in plain torch
# ---------------------------------------------------------------------------


def _kernel_terms():
    """B_TERMS as csrc/ssm_scan_bwd.cu sets it."""
    src = os.path.join(os.path.dirname(ssm_ops.__file__), "..", "csrc", "ssm_scan_bwd.cu")
    return int(re.search(r"constexpr int B_TERMS = (\d+);", open(src).read()).group(1))


def split_bf16(x, terms):
    """x (f32) as ``terms`` bf16 tensors whose sum it is (the kernel's
    ``split_bf16``), each in f32, the small terms first (the kernel's order)."""
    parts = []
    for _ in range(terms):
        part = x.to(BF16).float()
        parts.append(part)
        x = x - part
    return parts[::-1]


def ssm_bwd_mma_emulation(u, ld, B, C, dy, d_state, chunk, terms=None):
    """The mma kernel's arithmetic on bf16 u, B, C, dy (B, C with H heads)
    and f32 ld and d_state: (du, dld, dB, dC) in f32, per head, before
    the casts. ``terms`` maps an operand of ``SPLIT`` to its bf16 terms
    (default: the kernel's)."""
    kt = _kernel_terms()
    terms = {k: kt for k in SPLIT} | (terms or {})
    bt, s, h, p = u.shape
    n = B.shape[-1]
    k = _chunks(u, ld, B, C, chunk)  # the f32 states of the same operands
    T = k.T
    pad = -s % T

    def chunked(t):  # (bt, nc, h, T, x)
        t = F.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(bt, -1, T, h, t.shape[-1]).permute(0, 1, 3, 2, 4)

    U, Bc, Cc, Y = (chunked(t) for t in (u, B, C, dy))
    ldc = F.pad(ld.float(), (0, 0, 0, pad)).reshape(bt, -1, T, h).permute(0, 1, 3, 2)
    nc = U.shape[1]
    dS = torch.zeros(bt, h, n, p) if d_state is None else d_state.float()
    tri = torch.ones(T, T, dtype=torch.bool).tril()
    du = torch.zeros(bt, nc, h, T, p)
    dB, dC = torch.zeros(bt, nc, h, T, n), torch.zeros(bt, nc, h, T, n)
    dld = torch.zeros(bt, nc, h, T, 1)
    for c in reversed(range(nc)):
        u_, B_, C_, y_ = U[:, c], Bc[:, c], Cc[:, c], Y[:, c]
        la = torch.cumsum(ldc[:, c], -1)
        ein, eout = torch.exp(la), torch.exp(la[..., -1:] - la)
        dtot = torch.exp(la[..., -1])
        L = torch.exp(torch.where(tri, la[..., :, None] - la[..., None, :], -float("inf")))
        dyu = y_ @ u_.transpose(-1, -2)
        G, A = (C_ @ B_.transpose(-1, -2)) * L, dyu * L
        a = G * dyu
        S_c = k.states[:, c]
        dSs = split_bf16(dS, terms["dS"])
        du_c = sum(B_ @ t for t in dSs) * eout[..., None]
        du_c = du_c + sum(t.transpose(-1, -2) @ y_ for t in split_bf16(G, terms["G"]))
        db_state = sum(u_ @ t.transpose(-1, -2) for t in dSs) * eout[..., None]
        dc_state = sum(y_ @ t.transpose(-1, -2) for t in split_bf16(S_c, terms["S_c"]))
        dc_state = dc_state * ein[..., None]
        As = split_bf16(A, terms["A"])
        dB[:, c] = db_state + sum(t.transpose(-1, -2) @ C_ for t in As)
        dC[:, c] = dc_state + sum(t @ B_ for t in As)
        f = (B_ * db_state).sum(-1)
        dla = a.sum(-1) - a.sum(-2) + (C_ * dc_state).sum(-1) - f
        dla[..., -1] += f.sum(-1) + dtot * (sum(dSs) * S_c).sum((-2, -1))
        dld[:, c, ..., 0] = torch.flip(torch.cumsum(torch.flip(dla, (-1,)), -1), (-1,))
        du[:, c] = du_c
        ye = y_ * ein[..., None]
        dS = dtot[..., None, None] * dS + sum(
            C_.transpose(-1, -2) @ t for t in split_bf16(ye, terms["dy_ein"]))

    def out(t):
        return t.permute(0, 1, 3, 2, 4).reshape(bt, nc * T, h, -1)[:, :s]

    return out(du), out(dld)[..., 0], out(dB), out(dC)


def _inputs(bt, s, h, p, n, seed, shared, with_dstate, dt_scale=1.0):
    """bf16 u, B, C, dy, f32 ld = dt * A as Mamba2 makes them (dt =
    softplus(normal) * dt_scale, A = -[1..H]) and an f32 d_state, from
    numpy; B and C with a head dim of 1 when shared."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    u = normal(bt, s, h, p).to(BF16)
    ld = -F.softplus(normal(bt, s, h)) * dt_scale * torch.arange(1, h + 1, dtype=F32)
    nb = 1 if shared else h
    B, C = normal(bt, s, nb, n).to(BF16), normal(bt, s, nb, n).to(BF16)
    dy = normal(bt, s, h, p).to(BF16)
    ds = normal(bt, h, n, p) if with_dstate else None
    return u, ld, B, C, dy, ds


def _gate_excess(got, want, shared):
    """Per gradient: max over entries of (|err| - one bf16 rounding of a
    du, dB, dC entry) / max|want|, the rounded gradients cast to bf16 as
    the wrapper returns them; dB and dC summed over the heads in f32 when
    shared. The card's gate is 1e-3."""
    out = []
    for i, (g, x) in enumerate(zip(got, want)):
        if shared and i >= 2:
            g, x = g.sum(2, keepdim=True), x.sum(2, keepdim=True)
        rounded = i != 1
        if rounded:
            g = g.to(BF16).float()
        err = (g - x).abs() - (2.0**-8 * x.abs() if rounded else 0.0)
        out.append((err.max() / x.abs().max()).item())
    return out


def _emulate(case, chunk, seed, terms=None, dt_scale=1.0):
    bt, s, h, p, n, shared, with_dstate = case
    u, ld, B, C, dy, ds = _inputs(bt, s, h, p, n, seed, shared, with_dstate, dt_scale)
    Bh, Ch = B.expand(bt, s, h, n), C.expand(bt, s, h, n)
    got = ssm_bwd_mma_emulation(u, ld, Bh, Ch, dy, ds, chunk, terms)
    return got, (u, ld, B, C, dy, ds)


# bt, s, h, p, n, B/C shared by the heads, d_state
EMU_CASES = {
    "zamba2 head, N = P = 64, S 128": (1, 128, 3, 64, 64, True, False),
    "zamba2 head with d_state": (1, 128, 3, 64, 64, True, True),
    "ragged S": (2, 200, 8, 64, 64, True, True),
    "S below the chunk": (2, 20, 4, 64, 64, False, False),
    "N = P = 16": (2, 40, 16, 16, 16, False, False),
    "ragged P tile, N 32": (2, 40, 3, 40, 32, True, True),
    "P over several tiles, N 96": (1, 100, 2, 192, 96, False, False),
}


def test_emulation_runs_the_kernels_terms():
    assert _kernel_terms() == 2


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", list(EMU_CASES))
def test_mma_emulation_meets_the_gate_against_the_closed_form(case, chunk):
    got, (u, ld, B, C, dy, ds) = _emulate(EMU_CASES[case], chunk, seed=7)
    h = u.shape[2]
    want = ssm_scan_bwd_ref(u.float(), ld, B.float().expand(-1, -1, h, -1),
                            C.float().expand(-1, -1, h, -1), dy.float(), ds, chunk)
    assert max(_gate_excess(got, want, EMU_CASES[case][5])) <= 1e-3


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", ["zamba2 head, N = P = 64, S 128", "zamba2 head with d_state"])
def test_mma_emulation_meets_the_gate_against_jax_grad(case, chunk):
    """jax.grad of <y, dy> (+ <state, d_state>) through the JAX package's
    ssm_scan_chunked_jnp, on the f32 values of the same bf16 operands (S
    is a multiple of the chunk: the JAX twin does not pad)."""
    got, (u, ld, B, C, dy, ds) = _emulate(EMU_CASES[case], chunk, seed=11)
    h = u.shape[2]
    npy = [t.float().expand(-1, -1, h, -1).contiguous().numpy() if t.shape[2] != h
           else t.float().numpy() for t in (u, ld, B, C, dy)]

    def f(u, ld, B, C):
        y, state = ssm_scan_chunked_jnp(u, ld, B, C, chunk=chunk)
        out = jnp.sum(y * npy[4])
        return out if ds is None else out + jnp.sum(state * ds.numpy())

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in npy[:4]))
    want = [torch.from_numpy(np.array(w)) for w in want]
    assert max(_gate_excess(got, want, EMU_CASES[case][5])) <= 1e-3


# Mamba2's light decays: dt = softplus(normal) * 0.1, within its dt range
# (dt_max = 0.1), on two heads (A = -1, -2): the state carries far
LIGHT = (1, 256, 2, 64, 64, True, True)


@pytest.mark.parametrize("operand", SPLIT)
def test_one_term_of_a_split_operand_misses_the_gate(operand):
    """Each operand the kernel splits, held to one bf16 term (the others
    at two), misses the gate; two terms meet it with room. (Over seeds 0-15
    of this case one term of each operand reaches 0.7-2.4x the gate, and
    all five miss it at seed 10.)"""
    u, ld, B, C, dy, ds = _inputs(*LIGHT[:5], 10, *LIGHT[5:], dt_scale=0.1)
    h = u.shape[2]
    Bh, Ch = B.expand(-1, -1, h, -1), C.expand(-1, -1, h, -1)
    want = ssm_scan_bwd_ref(u.float(), ld, Bh.float(), Ch.float(), dy.float(), ds, 32)
    one = ssm_bwd_mma_emulation(u, ld, Bh, Ch, dy, ds, 32, {operand: 1})
    assert max(_gate_excess(one, want, True)) > 1e-3
    two = ssm_bwd_mma_emulation(u, ld, Bh, Ch, dy, ds, 32)
    assert max(_gate_excess(two, want, True)) <= 1e-4
