"""``decode_attention`` on the CPU (its plain version,
``decode_attention_ref``) against the JAX package's ``decode_attention``,
on the layouts the serving paths hold, and its meta branch (the dry-run's
accounting) against ``visible_slots`` and ``einsum_flops``.

Cases: per-batch length tensors with a zero-length row; a window that
excludes everything (exact zeros, lse -inf); GQA ratios 1, 4 and 8; head
dims 64, 80 and 128; bf16 and f32 caches; strided caches (a rank's slice
of the slots, one layer of a stacked cross cache); ``return_lse``.

Tolerance, as ``tests/test_torch_flash.py``'s: f32, 2e-5 absolute (convex
mixtures of v rows, f32 sums in another order); bf16, one bf16 ulp of
each entry (2**-7) plus 1e-6. ``return_lse``'s o is the f32 output before
the cast, its lse held against a numpy log-sum-exp of the same scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.kernels.flash_attention import decode_attention as jax_decode_attention
from repro_torch.kernels import decode_attention, launch_counts
from repro_torch.kernels._meta import einsum_flops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.accounting import Accounting

F32_TOL = 2e-5


def _arrays(b, s, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 1, h, d)).astype(np.float32),
            rng.normal(size=(b, s, kvh, d)).astype(np.float32),
            rng.normal(size=(b, s, kvh, d)).astype(np.float32))


def _reference(q, kc, vc, length, window, dtype):
    jl = jnp.asarray(length) if not isinstance(length, int) else length
    out = jax_decode_attention(*(jnp.asarray(a, dtype) for a in (q, kc, vc)), length=jl,
                               window=window)
    return np.asarray(out, np.float32)


def _lse_numpy(q, kc, length, window, qdtype):
    """Each row's log-sum-exp of its scaled scores over its visible slots
    (q and the cache in ``qdtype``, q rounded again after the scale, as
    both packages do)."""
    b, _, h, d = q.shape
    s, kvh = kc.shape[1], kc.shape[2]
    qr = (torch.from_numpy(q).to(qdtype).float() * d**-0.5).to(qdtype).float().numpy()
    kr = torch.from_numpy(kc).to(qdtype).float().numpy()
    lengths = np.broadcast_to(np.asarray(length), (b,))
    out = np.full((b, 1, h), -np.inf)
    for i in range(b):
        lo = max(0, int(lengths[i]) - window) if window is not None else 0
        hi = min(int(lengths[i]), s)
        if hi <= lo:
            continue
        for j in range(h):
            x = kr[i, lo:hi, j // (h // kvh)].astype(np.float64) @ qr[i, 0, j]
            out[i, 0, j] = x.max() + np.log(np.exp(x - x.max()).sum())
    return out


CASES = [  # b, s, h, kvh, d, length, window
    (2, 48, 4, 4, 64, 40, None),           # GQA 1
    (3, 40, 8, 2, 80, [40, 0, 17], None),  # GQA 4, a zero-length row
    (2, 64, 8, 1, 128, [33, 64], 16),      # GQA 8, a window
    (2, 24, 4, 1, 64, 20, 0),              # a window that excludes everything
    (2, 32, 8, 2, 128, [0, 0], None),      # no row has a slot
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("return_lse", [False, True])
def test_decode_matches_the_reference(case, dtype, return_lse):
    b, s, h, kvh, d, length, window = case
    q, kc, vc = _arrays(b, s, h, kvh, d, seed=b * s + d)
    tdt = getattr(torch, dtype)
    length_t = torch.tensor(length) if isinstance(length, list) else length
    ins = [torch.from_numpy(a).to(tdt) for a in (q, kc, vc)]
    before = launch_counts()
    got = decode_attention(*ins, length=length_t, window=window, return_lse=return_lse)
    assert launch_counts() == before  # CPU tensors: the plain version, no launch
    o, lse = got if return_lse else (got, None)
    want = _reference(q, kc, vc, length if not isinstance(length, list) else np.asarray(length),
                      window, dtype)
    assert o.dtype == (torch.float32 if return_lse else tdt)
    o = o.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(o, want, rtol=0, atol=F32_TOL)
    else:  # the reference rounds its f32 output once to bf16; o (lse path) is before it
        assert np.all(np.abs(o - want) <= 2.0**-7 * np.abs(want) + 1e-6)
    want_lse = _lse_numpy(q, kc, length, window, tdt)
    dead = np.isinf(want_lse)
    assert np.all(o[dead] == 0.0)  # exact zeros, not the mean of v
    if return_lse:
        lse = lse.numpy()
        assert np.all(lse[dead] == -np.inf)
        np.testing.assert_allclose(lse[~dead], want_lse[~dead], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strided_caches_match_the_reference(dtype):
    """A rank's slice of the slots and one layer of a stacked (L, B, S, KVH,
    D) cross cache: views of larger tensors, not contiguous."""
    rng = np.random.default_rng(3)
    stacked = rng.normal(size=(2, 2, 96, 4, 64)).astype(np.float32)
    q = rng.normal(size=(2, 1, 8, 64)).astype(np.float32)
    tdt = getattr(torch, dtype)
    full = torch.from_numpy(stacked).to(tdt)
    kc, vc = full[1, :, 32:], full[0, :, 32:]
    assert not kc.is_contiguous()
    got = decode_attention(torch.from_numpy(q).to(tdt), kc, vc, length=50, window=24)
    want = _reference(q, stacked[1, :, 32:], stacked[0, :, 32:], 50, 24, dtype)
    tol = F32_TOL if dtype == "float32" else 2.0**-7 * np.abs(want) + 1e-6
    assert np.all(np.abs(got.float().numpy() - want) <= tol)


@pytest.mark.parametrize("b,s,h,kvh,d,length,window,lse", [
    (4, 160, 9, 3, 64, 131, None, False), (2, 1500, 16, 16, 64, 1500, None, False),
    (3, 40, 8, 2, 80, [40, 0, 17], 16, True), (2, 24, 4, 1, 128, 20, 0, False)])
def test_meta_charge_counts_visible_slots_and_the_plain_flops(b, s, h, kvh, d, length, window,
                                                              lse):
    """The charge's bytes: q once, each row's visible K and V rows once, o
    (f32 under ``return_lse``) and lse once; its operations 4 D per
    visible slot and query head; its FLOPs the plain version's two einsums
    as ``torch.utils.flop_counter`` counts them on the CPU."""
    rows = length if isinstance(length, list) else [length] * b
    lengths = [int(n) for n in rows]
    vis = flash_ops.visible_slots(s, lengths, window)
    assert vis == [sum(1 for p in range(s) if p < n and (window is None or p >= n - window))
                   for n in lengths]
    w = flash_ops.decode_work(b, s, h, kvh, d, 2, 2, lengths, window, lse)
    o_es = 4 if lse else 2
    assert w.bytes == (b * h * d * 2 + 2 * kvh * d * 2 * sum(vis) + b * h * d * o_es
                       + 4 * b * h * lse)
    assert w.ops == 4 * d * h * sum(vis)
    assert w.flops == einsum_flops((d, b * h * s * d), (s, b * h * s * d))
    q = torch.zeros(b, 1, h, d)
    kc = torch.zeros(b, s, kvh, d)
    length_t = torch.tensor(length) if isinstance(length, list) else length
    with FlopCounterMode(display=False) as fc:
        decode_attention(q, kc, kc, length=length_t, window=window, return_lse=lse)
    assert fc.get_total_flops() == w.flops
    if not isinstance(length, list):  # a meta length tensor has no values to count
        meta = [t.to(torch.bfloat16).to("meta") for t in (q, kc)]
        before = launch_counts()
        with Accounting() as acc:
            out = decode_attention(meta[0], meta[1], meta[1], length=length, window=window,
                                   return_lse=lse)
        assert launch_counts() == before
        assert acc.launches == {"decode_attention": {"split": 1}}
        assert acc.kernels["decode_attention"] == {"flops": w.flops, "bytes": w.bytes}
        o = out[0] if lse else out
        assert o.device.type == "meta" and o.shape == (b, 1, h, d)


def test_split_plan_fills_the_card_from_shapes_alone():
    assert flash_ops.split_plan(4, 16, 1500) == 5       # whisper's cross cache: 64 pairs
    assert flash_ops.split_plan(4, 8, 1600) == 9        # the vision cross cache: 32 pairs
    assert flash_ops.split_plan(4, 3, 160) == 2         # smollm's self cache, 2 tiles long
    assert flash_ops.split_plan(64, 16, 4096) == 1      # enough pairs for the card
    assert flash_ops.split_plan(1, 1, 10**6) == 64


def test_the_kernel_branch_reads_lengths_where_they_are():
    """On the kernel's branch (meta tensors here, as on the card) a
    per-batch length off the kernel's device raises: it is never copied
    over. A length on the device, of 1 or B rows, is taken."""
    q = torch.empty(2, 1, 4, 64, device="meta")
    kc = torch.empty(2, 16, 2, 64, device="meta")
    with pytest.raises(ValueError, match="lengths on cpu"):
        decode_attention(q, kc, kc, length=torch.tensor([3, 4]))
    with pytest.raises(ValueError, match="int32/int64"):
        decode_attention(q, kc, kc, length=torch.tensor([3, 4, 5], device="meta"))
    with pytest.raises(TypeError, match="an int or a tensor"):
        decode_attention(q, kc, kc, length=[3, 4])
    for n in (torch.tensor([3, 4], device="meta"), torch.tensor(3, device="meta"), 7):
        with Accounting() as acc:
            decode_attention(q, kc, kc, length=n)
        assert acc.launches == {"decode_attention": {"split": 1}}
