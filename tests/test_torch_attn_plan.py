"""The flash_attention planner (``repro_torch.kernels.flash_attention.plan``)
and a plain-torch emulation of its ``mma`` variant's numerics, on the CPU.

The planner picks the CUDA kernel from dtype, head dim and layout alone:
``mma`` for bf16 operands whose rows start on 16 bytes (unit head-dim
stride, the other strides multiples of 8 elements, aligned bases), ``fma``
for f32 and for bf16 layouts ``mma`` cannot take; it raises for what
neither takes.

The emulation repeats the ``mma`` kernel's arithmetic in f32 on bf16
operands (``csrc/flash_attention.cu``): S = Q K^T summed in f32, the scale
applied to S, the online softmax over KV tiles of 64 keys (32 at D 256),
and P V with P split into three bf16 terms (hi, mid, lo) whose products
are summed in f32, l kept from the f32 P. It is held, at the card check's
own tolerance (``chip_smoke.py`` ``check_flash``: 1e-5 + 2**-8 of each
entry, against the f32 result of the same bf16 operands), against the
port's ``attention_ref`` and the JAX package's ``flash_attention_jnp``,
at reduced widths and at the main paths' heads (D 64 and D 80, S 128).
So the split meets the gate before any card runs it. One term is shown
to miss the gate, and two to meet it with little room.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_jnp
from repro_torch.kernels.flash_attention import HEAD_DIMS, NEG_INF, VARIANTS, attention_ref, plan

BF16, F32 = torch.bfloat16, torch.float32


def _strides(b, s, h, d):
    return (s * h * d, h * d, d, 1)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype,want", [(BF16, "mma"), (F32, "fma")])
def test_contiguous_operands_plan_by_dtype(d, dtype, want):
    st = _strides(4, 128, 9, d)
    assert plan(dtype, d, (st, st, st), True) == want


@pytest.mark.parametrize("arch,h,kvh,d", [("smollm-135m", 9, 3, 64), ("zamba2-2.7b", 32, 32, 80)])
def test_main_path_layouts_plan_to_mma(arch, h, kvh, d):
    """The serving paths' q (B, S, H, D) and k, v (B, S, KVH, D), as the
    projections and rope leave them: contiguous, bf16."""
    q, kv = _strides(4, 128, h, d), _strides(4, 128, kvh, d)
    assert plan(BF16, d, (q, kv, kv), True) == "mma"


@pytest.mark.parametrize("d", [64, 80, 128])
def test_fused_projection_views_plan_to_mma(d):
    """q, k, v as column slices of one (B, S, H, 3D) tensor: rows 3D apart,
    16-byte aligned, so mma reads them through their strides."""
    st = (128 * 4 * 3 * d, 4 * 3 * d, 3 * d, 1)
    assert plan(BF16, d, (st, st, st), True) == "mma"


@pytest.mark.parametrize("which", [0, 1, 2])
def test_misaligned_base_plans_to_fma(which):
    st = _strides(2, 64, 4, 64)
    assert plan(BF16, 64, (st, st, st), False) == "fma"
    # an odd row stride in any operand moves its rows off 16 bytes
    odd = list((st, st, st))
    odd[which] = (st[0], st[1] + 1, st[2], 1)
    assert plan(BF16, 64, tuple(odd), True) == "fma"


@pytest.mark.parametrize("bad_axis", [0, 1, 2])
def test_strides_off_multiples_of_eight_plan_to_fma(bad_axis):
    st = list(_strides(2, 64, 4, 64))
    st[bad_axis] += 4  # 8 bytes: rows no longer start on 16
    assert plan(BF16, 64, (tuple(st), _strides(2, 64, 4, 64), _strides(2, 64, 4, 64)),
                True) == "fma"


def test_broadcast_kv_heads_plan_to_mma():
    """A KV tensor expanded over heads (head stride 0) still has aligned rows."""
    kv = (128 * 64, 64, 0, 1)
    assert plan(BF16, 64, (_strides(2, 128, 4, 64), kv, kv), True) == "mma"


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_unbuilt_dtypes_raise(dtype):
    st = _strides(1, 8, 2, 64)
    with pytest.raises(TypeError):
        plan(dtype, 64, (st, st, st), True)


@pytest.mark.parametrize("d", [16, 48, 96, 512])
def test_unbuilt_head_dims_raise(d):
    st = _strides(1, 8, 2, d)
    with pytest.raises(ValueError, match="head dim"):
        plan(BF16, d, (st, st, st), True)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_non_unit_head_dim_stride_raises(dtype):
    st = _strides(1, 8, 2, 64)
    strided = (st[0] * 2, st[1] * 2, st[2] * 2, 2)
    with pytest.raises(ValueError, match="unit stride"):
        plan(dtype, 64, (st, strided, st), True)


def test_wrapper_counts_variants_only_on_the_card():
    """On the CPU the wrapper runs its plain version and launches nothing."""
    from repro_torch.kernels.flash_attention import flash_attention

    assert tuple(flash_attention.variants) == VARIANTS
    before = dict(flash_attention.variants)
    q = torch.randn(1, 8, 2, 64, dtype=BF16)
    flash_attention(q, q, q)
    assert flash_attention.variants == before


# ---------------------------------------------------------------------------
# the mma variant's numerics, emulated in plain torch
# ---------------------------------------------------------------------------


def split_bf16(x, terms):
    """x (f32) as ``terms`` bf16 tensors whose sum it is, each taking what
    the earlier ones left: the kernel's ``split_bf16``."""
    parts = []
    for _ in range(terms):
        part = x.to(BF16)
        parts.append(part.float())
        x = x - part.float()
    return parts


def flash_mma_emulation(q, k, v, *, causal=True, window=None, q_offset=0, terms=3):
    """The mma kernel's arithmetic on bf16 q, k, v (B, S, H, D): returns the
    f32 output before its rounding to bf16."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    bk = 64 if d <= 128 else 32
    scale = 1.0 / math.sqrt(d)
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)
    qi = torch.arange(sq)[:, None] + q_offset
    m = torch.full((b, h, sq), NEG_INF)
    l = torch.zeros(b, h, sq)
    acc = torch.zeros(b, h, sq, d)
    for k0 in range(0, skv, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = (qf @ kt.transpose(-1, -2)) * scale  # exact bf16 products, f32 sums, then the scale
        kj = torch.arange(k0, k0 + kt.shape[2])[None, :]
        visible = torch.ones(sq, kt.shape[2], dtype=torch.bool)
        if causal:
            visible &= kj <= qi
        if window is not None:
            visible &= kj > qi - window
        s = torch.where(visible, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        # the small terms first, as the kernel issues them
        acc = acc * corr[..., None] + sum(part @ vt for part in reversed(split_bf16(p, terms)))
        m = m_new
    return (acc / l[..., None]).permute(0, 2, 1, 3)


def _inputs(b, s, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, s, hh, d), dtype=np.float32)).to(BF16)
                 for hh in (h, kvh, kvh))


def _within_gate(out_f32, exact):
    """chip_smoke.py's check_flash on a bf16 output."""
    err = (out_f32.to(BF16).float() - exact).abs()
    return bool((err <= 1e-5 + 2.0**-8 * exact.abs()).all())


# b, s, h, kvh, d, causal, window, q_offset
EMU_CASES = {
    "smollm head, D 64": (1, 128, 3, 1, 64, True, 2**30, 0),
    "zamba2 heads, D 80": (1, 128, 2, 2, 80, True, None, 0),
    "reduced, D 32, window": (2, 96, 4, 2, 32, True, 16, 0),
    "reduced, D 128, no mask": (1, 70, 2, 1, 128, False, None, 0),
    "D 256, ragged": (1, 90, 2, 1, 256, True, None, 0),
    "queries at an offset": (1, 40, 4, 2, 64, True, None, 60),
    "no visible key": (1, 70, 2, 1, 64, True, 0, 0),
}


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_mma_emulation_meets_the_gate_against_attention_ref(case):
    b, s, h, kvh, d, causal, window, q_offset = EMU_CASES[case]
    sk = s + q_offset
    q = _inputs(b, s, h, kvh, d, seed=d)[0]
    k, v = _inputs(b, sk, h, kvh, d, seed=d + 1)[1:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    exact = attention_ref(q.float(), k.float(), v.float(), **kw)
    assert _within_gate(flash_mma_emulation(q, k, v, **kw), exact)


@pytest.mark.parametrize("case", ["smollm head, D 64", "zamba2 heads, D 80", "reduced, D 32, window",
                                  "queries at an offset"])
def test_mma_emulation_meets_the_gate_against_the_jax_package(case):
    b, s, h, kvh, d, causal, window, q_offset = EMU_CASES[case]
    q = _inputs(b, s, h, kvh, d, seed=d)[0]
    k, v = _inputs(b, s + q_offset, h, kvh, d, seed=d + 1)[1:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ref = flash_attention_jnp(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)), chunk=64, **kw)
    assert _within_gate(flash_mma_emulation(q, k, v, **kw), torch.from_numpy(np.array(ref)))


@pytest.mark.parametrize("terms", [1, 2])
def test_fewer_terms_of_p_miss_the_gate(terms):
    """One term (P rounded to bf16, as the usual flash kernels do) misses
    the gate at the main shape; two leave up to 2**-16 of P, which comes
    within a few parts in 1e6 of the 1e-5 slack. Three terms are what the
    kernel runs."""
    q, k, v = _inputs(2, 128, 8, 2, 64, seed=3)
    exact = attention_ref(q.float(), k.float(), v.float())
    err = {t: (flash_mma_emulation(q, k, v, terms=t) - exact).abs().max().item()
           for t in (terms, 3)}
    assert err[3] < 2e-6
    if terms == 1:
        assert not _within_gate(flash_mma_emulation(q, k, v, terms=1), exact)
    else:
        assert 2e-6 < err[2] < 1e-5  # inside, but with little room


def test_split_terms_reconstruct_f32():
    x = torch.rand(4096) * torch.exp(torch.randn(4096) * 4)
    for terms, bound in ((1, 2.0**-8), (2, 2.0**-16), (3, 2.0**-24)):
        rest = (x - sum(split_bf16(x, terms))).abs()
        assert bool((rest <= bound * x.abs()).all()), terms
