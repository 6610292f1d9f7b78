"""The port's attention backward (plain versions, on the CPU) against the
JAX package's flash-2 custom VJP, on the same numpy inputs; the
backward's variant plan; and a plain-torch emulation of the ``mma``
backward kernels' split-bf16 arithmetic held to the card check's gate.

- ``attention_fwd_ref``'s lse against ``chunked._fwd_impl``'s;
- ``attention_bwd_ref`` (fed the port's o and lse), and the gradients of
  the port's ``flash_attention`` through its autograd Function, against
  ``jax.vjp`` of ``flash_attention_jnp`` with the same output cotangent;
- against torch autograd of ``attention_ref`` where the reference's
  chunked forward differs from the port's: rows with no visible key
  (the reference averages them over its padded chunk slots, the port
  over Skv) and Skv that is not a multiple of the chunk.

Tolerance: rtol 5e-3, atol 5e-4 in f32, as tests/test_kernel_flash.py
holds the chunked VJP against autodiff of the reference's oracle; the
same f32 formulas summed in another order agree far inside it. lse:
rtol 1e-5 (one log of an f32 sum). Against torch autograd: 1e-5 of the
gradient's largest entry (the same arithmetic, reordered).
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.chunked import _fwd_impl
from repro.kernels.flash_attention.ops import flash_attention_jnp
from repro_torch.kernels import flash_attention, flash_attention_bwd, launch_counts
from repro_torch.kernels.flash_attention import (HEAD_DIMS, VARIANTS, attention_bwd_ref,
                                                 attention_fwd_ref, attention_ref, plan)
from repro_torch.kernels.flash_attention import ops as flash_ops

RTOL, ATOL = 5e-3, 5e-4

# b, sq, skv, h, kvh, d, causal, window, q_offset: tests/test_kernel_flash.py's
# cases and GQA extremes, a window, a query offset and ragged lengths
CASES = [
    (2, 256, 256, 4, 2, 64, True, None, 0),
    (1, 128, 128, 8, 1, 64, True, 128, 0),
    (2, 256, 512, 4, 4, 32, False, None, 0),  # cross
    (1, 384, 384, 2, 2, 128, True, 64, 0),  # sliding window
    (2, 128, 128, 4, 4, 64, True, None, 0),  # MHA
    (2, 128, 128, 16, 1, 64, True, None, 0),  # MQA
    (2, 128, 128, 8, 2, 64, True, None, 0),
    (2, 64, 200, 4, 2, 32, True, None, 136),  # queries at the end of the keys
    (1, 200, 200, 4, 2, 32, True, 48, 0),  # ragged, window
]


def _inputs(b, sq, skv, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d), (b, sq, h, d)))


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_lse_matches_chunked_forward(case):
    b, sq, skv, h, kvh, d, causal, window, q_offset = case
    q, k, v, _ = _inputs(b, sq, skv, h, kvh, d)
    g = h // kvh
    qt = jnp.asarray(q).reshape(b, sq, kvh, g, d).transpose(0, 2, 3, 1, 4)
    kt, vt = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (k, v))
    win = jnp.float32(jnp.inf) if window is None else jnp.float32(window)
    fwd = jax.jit(lambda *x: _fwd_impl(*x, causal, 1.0 / d**0.5, q_offset, min(64, skv))[1])
    jlse = fwd(qt, kt, vt, win)
    o, lse = attention_fwd_ref(*_torch(q, k, v), causal=causal, window=window, q_offset=q_offset)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(b, h, sq), rtol=1e-5)
    ref = attention_ref(*_torch(q, k, v), causal=causal, window=window, q_offset=q_offset)
    np.testing.assert_allclose(o.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_grads_match_reference_vjp(case):
    b, sq, skv, h, kvh, d, causal, window, q_offset = case
    q, k, v, do = _inputs(b, sq, skv, h, kvh, d, seed=3)
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    @jax.jit
    def vjp(q_, k_, v_, do_):
        return jax.vjp(lambda *x: flash_attention_jnp(*x, chunk=64, **kw), q_, k_, v_)[1](do_)

    want = [np.asarray(x) for x in vjp(*(jnp.asarray(x) for x in (q, k, v, do)))]

    o, lse = attention_fwd_ref(*_torch(q, k, v), **kw)
    plain = attention_bwd_ref(*_torch(q, k, v), o, torch.from_numpy(do), lse, **kw)
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    before = launch_counts()
    out = flash_attention(tq, tk, tv, **kw)
    through_fn = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert launch_counts() == before  # CPU tensors: the plain versions, no kernel
    for name, w, p, f in zip("qkv", want, plain, through_fn):
        np.testing.assert_allclose(p.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=f"d{name}")
        np.testing.assert_array_equal(f.numpy(), p.numpy(), err_msg=f"d{name} via Function")


# cases where the reference's chunked forward is not the port's forward:
# rows with no visible key, and Skv not a multiple of the chunk
EXACT_CASES = [
    (1, 70, 70, 2, 1, 16, True, 0, 0),  # window 0: no row sees a key
    (1, 48, 48, 4, 2, 16, True, 8, -20),  # the first 20 rows see no key
    (2, 33, 77, 4, 2, 16, False, 5, 60),  # ragged, a narrow window
    (2, 40, 40, 6, 3, 32, True, None, 0),
]


@pytest.mark.parametrize("case", EXACT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bwd_is_the_exact_gradient_of_the_port_forward(case):
    b, sq, skv, h, kvh, d, causal, window, q_offset = case
    q, k, v, do = _torch(*_inputs(b, sq, skv, h, kvh, d, seed=5))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, do)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    got = attention_bwd_ref(q, k, v, o, do, lse, **kw)
    for name, g, w in zip("qkv", got, want):
        assert torch.isfinite(g).all()
        scale = max(w.abs().max().item(), 1e-30)
        assert (g - w).abs().max().item() <= 1e-5 * scale, f"d{name}"


def test_bwd_keeps_operand_dtypes_and_wrapper_takes_the_plain_version():
    q, k, v, do = (t.to(torch.bfloat16) for t in _torch(*_inputs(1, 16, 16, 4, 2, 32)))
    o, lse = attention_fwd_ref(q, k, v)
    before = flash_attention_bwd.launches
    grads = flash_attention_bwd(q, k, v, o, do, lse)
    assert flash_attention_bwd.launches == before
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [tuple(g.shape) for g in grads] == [tuple(q.shape), tuple(k.shape), tuple(v.shape)]
    for g, w in zip(grads, attention_bwd_ref(q, k, v, o, do, lse)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the backward's variant plan and the mma kernels' numerics, emulated
# ---------------------------------------------------------------------------
#
# ``flash_attention_bwd`` picks its kernel with ``plan`` over q, k, v, o and
# dO: ``mma`` (the tensor-core kernels of csrc/flash_attention_bwd.cu) for
# bf16 operands whose rows start on 16 bytes, ``fma`` for f32 and for the
# bf16 layouts mma cannot take; it raises for a head dim neither builds.

BF16, F32 = torch.bfloat16, torch.float32


def _strides(s, h, d):
    return (s * h * d, h * d, d, 1)


def _bwd_strides(s, h, kvh, d):
    """(b, s, h, d) strides of contiguous q, k, v, o, dO."""
    q, kv = _strides(s, h, d), _strides(s, kvh, d)
    return (q, kv, kv, q, q)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype,want", [(BF16, "mma"), (F32, "fma")])
def test_bwd_plan_by_dtype(d, dtype, want):
    assert plan(dtype, d, _bwd_strides(512, 9, 3, d), True) == want


@pytest.mark.parametrize("which", range(5))
def test_bwd_plan_unaligned_bf16_takes_fma(which):
    """A base off 16 bytes, or any one of the five operands with rows off
    16 bytes (a row stride not a multiple of 8 elements), runs fma."""
    st = _bwd_strides(128, 4, 2, 64)
    assert plan(BF16, 64, st, False) == "fma"
    odd = list(st)
    odd[which] = (st[which][0], st[which][1] + 4, st[which][2], 1)
    assert plan(BF16, 64, tuple(odd), True) == "fma"


def test_bwd_plan_of_strided_rows_is_mma():
    """Every other row of tensors twice as long (chip_smoke's "seq stride
    2" layout): rows still start on 16 bytes."""
    st = tuple((x[0], 2 * x[1], x[2], 1) for x in _bwd_strides(256, 4, 2, 64))
    assert plan(BF16, 64, st, True) == "mma"


@pytest.mark.parametrize("d", [16, 48, 96, 512])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_bwd_plan_raises_for_unbuilt_head_dims(d, dtype):
    with pytest.raises(ValueError, match="head dim"):
        plan(dtype, d, _bwd_strides(64, 4, 2, d), True)


def test_bwd_variants_are_counted_only_on_the_card():
    assert tuple(flash_attention_bwd.variants) == VARIANTS
    q, k, v, do = (t.to(BF16) for t in _torch(*_inputs(1, 16, 16, 4, 2, 32)))
    o, lse = attention_fwd_ref(q, k, v)
    before = dict(flash_attention_bwd.variants)
    flash_attention_bwd(q, k, v, o, do, lse)
    assert flash_attention_bwd.variants == before


# The mma kernels' arithmetic in plain torch: bf16 operands, their products
# exact and summed in f32 (S, dP, D), p = 2^(s scale log2 e - lse log2 e)
# and dS in f32, and P and dS as operands of dV, dK and dQ split into the
# kernel's BWD_TERMS bf16 terms whose products sum in f32. Held to
# chip_smoke.py's gate (check_flash_bwd): each bf16 gradient within 1e-5
# of its largest entry plus one bf16 rounding (2**-8 of each entry) of the
# f32 backward of the same operands (attention_bwd_ref; o, dO, lse
# included), on phase 12's edge shapes with the batch cut to 1.

LOG2E = 1.4426950408889634


def kernel_terms():
    """BWD_TERMS as csrc/flash_attention_bwd.cu sets it."""
    src = os.path.join(os.path.dirname(flash_ops.__file__), "..", "csrc",
                       "flash_attention_bwd.cu")
    return int(re.search(r"constexpr int BWD_TERMS = (\d+);", open(src).read()).group(1))


def split_bf16(x, terms):
    """x (f32) as ``terms`` bf16-valued tensors whose sum it is, each taking
    what the earlier ones left: mma_util.cuh's split_bf16."""
    parts = []
    for _ in range(terms):
        part = x.to(BF16).float()
        parts.append(part)
        x = x - part
    return parts


def mma_bwd_emulation(q, k, v, o, do, lse, terms, *, causal=True, window=None, q_offset=0):
    """(dq, dk, dv) in f32, before the kernels round them to bf16."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)

    def heads(t):  # (B, Sq, H, D) -> (B, KVH, G, Sq, D)
        return t.float().reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4)

    qf, dof, of = heads(q), heads(do), heads(o)
    kf, vf = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    dsum = (dof * of).sum(-1)[..., None]
    s = qf @ kf.transpose(-1, -2)
    dp = dof @ vf.transpose(-1, -2)
    # each row's visible keys [lo, hi), as the kernels' row_keys
    pos = torch.arange(sq)[:, None] + q_offset
    lo = (pos - window + 1).clamp(min=0) if window is not None else torch.zeros_like(pos)
    hi = (pos + 1).clamp(max=skv) if causal else torch.full_like(pos, skv)
    kj = torch.arange(skv)[None, :]
    vis = (kj >= lo) & (kj < hi)
    dead = (lo >= hi).expand(sq, skv)
    p = torch.exp2(s * (scale * LOG2E) - lse.reshape(b, kvh, g, sq, 1) * LOG2E)
    ds = torch.where(vis, p * (dp - dsum) * scale, 0.0)
    p = torch.where(vis, p, torch.where(dead, 1.0 / skv, 0.0))
    dv = sum(t.transpose(-1, -2) @ dof for t in reversed(split_bf16(p, terms))).sum(2)
    dk = sum(t.transpose(-1, -2) @ qf for t in reversed(split_bf16(ds, terms))).sum(2)
    dq = sum(t @ kf for t in reversed(split_bf16(ds, terms)))
    return (dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d), dk.permute(0, 2, 1, 3),
            dv.permute(0, 2, 1, 3))


def gate_slack(got_f32, exact):
    """chip_smoke.py's _bwd_gate on the bf16 rounding of ``got_f32``: the
    largest share of the 1e-5 slack an entry uses beyond one rounding
    (the gate holds while it is at most 1)."""
    worst = -math.inf
    for got, ex in zip(got_f32, exact):
        err = (got.to(BF16).float() - ex).abs()
        abs_tol = 1e-5 * max(1.0, ex.abs().max().item())
        worst = max(worst, ((err - 2.0**-8 * ex.abs()) / abs_tol).max().item())
    return worst


# b, sq, skv, h, kvh, d, causal, window, q_offset: phase 12's shapes
BWD_EMU_CASES = {
    "training shape, one batch": (1, 512, 512, 9, 3, 64, True, 2**30, 0),
    **{f"D {d}, ragged": (1, 100, 100, 6, 2, d, True, None, 0) for d in HEAD_DIMS},
    "GQA 4/4": (1, 128, 128, 4, 4, 64, True, None, 0),
    "GQA 16/1": (1, 128, 128, 16, 1, 64, True, None, 0),
    "GQA 8/2": (1, 128, 128, 8, 2, 64, True, None, 0),
    "D 256, a window that binds": (1, 256, 256, 4, 1, 256, True, 128, 0),
    "ragged, no mask": (1, 200, 333, 4, 2, 64, False, None, 0),
    "queries at the end": (1, 200, 333, 4, 2, 64, True, None, 133),
    "queries at the end, a window": (1, 64, 200, 4, 2, 32, True, 16, 136),
    "no visible key": (1, 70, 70, 2, 1, 64, True, 0, 0),
}


def _emu_case(case, seed=0):
    b, sq, skv, h, kvh, d, causal, window, q_offset = BWD_EMU_CASES[case]
    q, k, v, do = (t.to(BF16) for t in _torch(*_inputs(b, sq, skv, h, kvh, d, seed=seed)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = attention_fwd_ref(q, k, v, **kw)  # o in bf16, as the forward kernel leaves it
    exact = attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), do.float(), lse, **kw)
    return (q, k, v, o, do, lse), kw, exact


@pytest.mark.parametrize("case", list(BWD_EMU_CASES))
def test_mma_bwd_emulation_meets_the_gate(case):
    ops_in, kw, exact = _emu_case(case)
    got = mma_bwd_emulation(*ops_in, kernel_terms(), **kw)
    assert all(torch.isfinite(g).all() for g in got)
    assert gate_slack(got, exact) <= 1.0


@pytest.mark.parametrize("case", ["training shape, one batch", "D 128, ragged",
                                  "D 256, a window that binds"])
def test_two_terms_leave_room_and_one_term_misses_the_gate(case):
    """Two terms (the kernel's) use at most 0.12 of the gate's 1e-5 slack
    beyond one rounding on these shapes (three at most 0.02); one term, P
    and dS rounded to bf16 as the usual flash kernels do, misses the gate
    about a hundred times over."""
    assert kernel_terms() == 2
    ops_in, kw, exact = _emu_case(case)
    slack = {t: gate_slack(mma_bwd_emulation(*ops_in, t, **kw), exact) for t in (1, 2, 3)}
    assert slack[3] < 0.05
    assert slack[2] < 0.25
    assert slack[1] > 50
