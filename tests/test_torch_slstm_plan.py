"""The sLSTM kernels' planner and the ``reg`` variants' arithmetic, on the CPU.

- ``plan(d)``: ``reg`` for d a multiple of 16 from 16 to ``REG_MAX_D``
  (192, xlstm-125m's head width; 32, its reduced config's), ``fma``
  elsewhere. The block ``reg`` runs at each width (threads, floats of r
  a thread, the slice stride that puts the four slices' float4 reads on
  distinct banks, shared memory) follows from the layout constants of
  ``csrc/slstm_reg.cuh``, which both kernels include and neither
  restates; the launchers take exactly the widths ``plan`` gives ``reg``.
- An emulation of each ``reg`` kernel's f32 order of operations: the
  matvec's KS slices, each summed as two chains of fused multiply-adds
  (even and odd float4 chunks) that meet, then the slices' butterfly
  ((p0 + p1) + (p2 + p3)); the backward's per-warp sums of dq q, dc
  c_{t-1} and dc z (a butterfly over the warp's 32 lanes, 16 of them
  owning a column), the fixed-order sum over warps, and the scalar dn
  recurrence finished after the walk. Each emulation is held against
  ``slstm_scan_ref``, ``slstm_scan_bwd_ref`` and autograd of the loop
  within 1e-5 of each output's max (f32 sums in another order), the
  gates' exact ties included (i_in == 10, n == 1). The gates' __expf and
  __fdividef round apart from torch's exp and divide by ~1e-6 of the
  scale; their effect is measured on the card (``chip_smoke.py``, the
  ``cuda`` tests), and the emulation computes the gates as the loop does.
"""

import os
import re

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels.slstm import ops, slstm_dr, slstm_scan_bwd_ref, slstm_scan_ref

TOL = 1e-5
CSRC = os.path.join(os.path.dirname(ops.__file__), "..", "csrc")
LAYOUT = ("KS", "CPT", "NSTAGE", "REG_MAX_D")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constants():
    """The reg layout's constants, as ``csrc/slstm_reg.cuh`` states them."""
    src = _source("slstm_reg.cuh")
    return {c: int(re.search(rf"constexpr int {c} = (\d+);", src).group(1)) for c in LAYOUT}


C = _constants()
KS = C["KS"]


def _geometry(d):
    """The reg block at head width d, from the header's constants and the
    kernels' Reg<D>, Fwd<D> and Bwd<D>: threads, floats of r a thread, the
    h (dz) buffer's slice stride, each kernel's shared memory in bytes."""
    kpt = d // KS
    stride = kpt if (kpt // 4) % 2 else kpt + 4
    threads = d // C["CPT"] * KS
    return {"threads": threads, "k_per_slice": kpt, "r_floats_per_thread": C["CPT"] * kpt,
            "slice_stride": stride,
            "fwd_smem_bytes": 4 * (2 * KS * stride + C["NSTAGE"] * (2 * d + 4)),
            "bwd_smem_bytes": 4 * (2 * KS * stride + C["NSTAGE"] * (4 * d + 4))}


def _reg_widths(name):
    return sorted(int(x) for x in re.findall(r"case (\d+): return launch_reg<\1>", _source(name)))


@pytest.mark.parametrize("d,threads,r_floats,stride", [(16, 32, 8, 4), (32, 64, 16, 12),
                                                       (48, 96, 24, 12), (192, 384, 96, 52)])
def test_plan_takes_reg_where_r_fits_in_registers(d, threads, r_floats, stride):
    assert ops.plan(d) == "reg"
    geo = _geometry(d)
    assert (geo["threads"], geo["r_floats_per_thread"], geo["slice_stride"]) == (
        threads, r_floats, stride)
    assert threads % 32 == 0 and geo["k_per_slice"] * KS == d
    # the four slices' float4 reads start on distinct 4-bank groups
    assert len({(g * stride // 4) % 8 for g in range(KS)}) == KS
    assert geo["fwd_smem_bytes"] < 48 * 1024 and geo["bwd_smem_bytes"] < 48 * 1024
    assert d in _reg_widths("slstm.cu") and d in _reg_widths("slstm_bwd.cu")


@pytest.mark.parametrize("d", [4, 8, 40, 100, 200, 208, 256, 1024])
def test_plan_falls_back_to_fma_elsewhere(d):
    assert ops.plan(d) == "fma"
    assert d not in _reg_widths("slstm.cu") and d not in _reg_widths("slstm_bwd.cu")


def test_xlstm_widths_plan_reg():
    for cfg in (get_config("xlstm-125m"), reduced(get_config("xlstm-125m"))):
        assert ops.plan(cfg.d_model // cfg.n_heads) == "reg", cfg


@pytest.mark.parametrize("name", ["slstm.cu", "slstm_bwd.cu"])
def test_constants_and_widths_match_the_kernels(name):
    src = _source(name)
    # the layout is the header's alone: the kernel includes it and restates none of it
    assert '#include "slstm_reg.cuh"' in src
    for const in LAYOUT:
        assert not re.search(rf"constexpr int {const} =", src), const
    assert C["REG_MAX_D"] == ops.REG_MAX_D
    assert _reg_widths(name) == [d for d in range(1, 1025) if ops.plan(d) == "reg"]
    assert ops.VARIANTS == ("reg", "fma")


# ---------------------------------------------------------------------------
# the reg kernels' arithmetic
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """f32 fused multiply-add: the product is exact in f64."""
    return (a.double() * b.double() + c.double()).float()


def _matvec(v, m):
    """out[..., col] = sum_k v[..., k] m[h, k, col] in the kernels' order:
    k in KS slices; a slice as two FMA chains over its float4 chunks
    (even chunks, odd chunks) that meet; the slices by a butterfly.
    v (B, H, D), m (H, D, D)."""
    b, h, d = v.shape
    kpt = d // KS
    acc = torch.zeros(b, h, KS, 2, d)
    vs = v.reshape(b, h, KS, kpt)
    ms = m.reshape(h, KS, kpt, d)
    for i in range(kpt // 4):
        for e in range(4):
            k = 4 * i + e
            acc[:, :, :, i % 2] = _fma(vs[:, :, :, k, None], ms[None, :, :, k], acc[:, :, :, i % 2])
    p = acc[:, :, :, 0] + acc[:, :, :, 1]  # (B, H, KS, D)
    while p.shape[2] > 1:  # xor LG, then 2 LG: neighbouring slices first
        p = p[:, :, 0::2] + p[:, :, 1::2]
    return p[:, :, 0]


def _sig(x):
    return 1.0 / (1.0 + torch.exp(-x))


def reg_forward(z_in, i_in, f_in, o_in, r, c0, n0, h0):
    """The reg forward's arithmetic: ``(ys, c, n, h), (c_all, n_all, z_all)``."""
    b, s, e = z_in.shape
    h, d = r.shape[0], r.shape[1]
    c, n, hp = c0.reshape(b, h, d), n0.clone(), h0.reshape(b, h, d)
    ys, cs, ns, zs = [], [], [], []
    for t in range(s):
        ig = torch.exp(torch.clamp(i_in[:, t], max=10.0))
        fg, og = _sig(f_in[:, t]), _sig(o_in[:, t].reshape(b, h, d))
        n = fg * n + ig
        m = torch.clamp(n, min=1.0)
        rec = _matvec(hp, r)
        z = torch.tanh(z_in[:, t].reshape(b, h, d) + rec)
        c = fg[..., None] * c + ig[..., None] * z
        hp = og * (c / m[..., None])
        ys.append(hp.reshape(b, e))
        cs.append(c.reshape(b, e))
        ns.append(n)
        zs.append(z.reshape(b, e))
    return ((torch.stack(ys, 1), c.reshape(b, e), n, hp.reshape(b, e)),
            (torch.stack(cs, 1), torch.stack(ns, 1), torch.stack(zs, 1)))


def _warp_sums(x):
    """x (B, H, D) -> (B, H, D / 16): each warp's sum of its 16 columns in
    the kernel's order. Lane 8 g + jj of warp w owns column 2 (8 w + jj)
    + g for g < 2 (the other 16 lanes add 0); a butterfly xor 16, 8, 4,
    2, 1 leaves every lane with the same sum."""
    b, h, d = x.shape
    nw = d // 16
    lanes = torch.zeros(b, h, nw, 32)
    cols = x.reshape(b, h, nw, 8, 2)  # (warp, jj, g)
    lanes[..., 0:8] = cols[..., 0]
    lanes[..., 8:16] = cols[..., 1]
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    return lanes[..., 0]


def reg_backward(i_in, f_in, o_in, r, c0, n0, saved, dys, dc=None, dn=None, dh=None):
    """The reg backward's arithmetic: ``(dz_in, di_in, df_in, do_in, dc0,
    dn0, dh0)``. The dz chain walks back step by step; the per-head sums
    are kept per step and warp and finished after the walk."""
    c_all, n_all, z_all = saved
    b, s, e = dys.shape
    h, d = r.shape[0], r.shape[1]
    pe = (lambda x: x.reshape(b, h, d))
    dc = torch.zeros(b, h, d) if dc is None else pe(dc)
    dh = torch.zeros(b, h, d) if dh is None else pe(dh)
    dn = torch.zeros(b, h) if dn is None else dn.clone()
    rt = r.transpose(1, 2)  # m[j, k] = r[k, j]
    dz_in, do_in = torch.empty_like(dys), torch.empty_like(dys)
    parts = [None] * s
    for t in reversed(range(s)):
        c, z, dy = pe(c_all[:, t]), pe(z_all[:, t]), pe(dys[:, t])
        c_prev = pe(c_all[:, t - 1]) if t else pe(c0)
        n = n_all[:, t]
        m = torch.clamp(n, min=1.0)[..., None]
        og = _sig(o_in[:, t].reshape(b, h, d))
        ig = torch.exp(torch.clamp(i_in[:, t], max=10.0))[..., None]
        fg = _sig(f_in[:, t])[..., None]
        dht = dy + dh
        q = c / m
        dq = dht * og
        dct = dc + dq / m
        dpre = dct * ig * (1 - z * z)
        dz_in[:, t] = dpre.reshape(b, e)
        do_in[:, t] = (dht * q * og * (1 - og)).reshape(b, e)
        parts[t] = [_warp_sums(v) for v in (dq * q, dct * c_prev, dct * z)]
        dc = dct * fg
        dh = _matvec(dpre, rt)
    # after the walk: the sums over warps in order, then dn's recurrence
    di_in, df_in = torch.empty_like(i_in), torch.empty_like(f_in)
    for t in reversed(range(s)):
        sums = []
        for p in parts[t]:
            tot = torch.zeros(b, h)
            for w in range(p.shape[-1]):
                tot = tot + p[..., w]
            sums.append(tot)
        s1, s2, s3 = sums
        n = n_all[:, t]
        n_prev = n_all[:, t - 1] if t else n0
        it = i_in[:, t]
        ig, fg = torch.exp(torch.clamp(it, max=10.0)), _sig(f_in[:, t])
        gate = torch.where(it < 10, 1.0, torch.where(it == 10, 0.5, 0.0))
        dm = -s1 / torch.clamp(n, min=1.0)
        dnt = dn + torch.where(n > 1, dm, torch.where(n == 1, 0.5 * dm, torch.zeros_like(dm)))
        di_in[:, t] = (s3 + dnt) * ig * gate
        df_in[:, t] = (s2 + dnt * n_prev) * fg * (1 - fg)
        dn = dnt * fg
    return dz_in, di_in, df_in, do_in, dc.reshape(b, e), dn, dh.reshape(b, e)


def _inputs(b, s, h, d, seed, zero_state=False, ties=False):
    g = torch.Generator().manual_seed(seed)
    e = h * d

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    z_in, o_in = rn(b, s, e), rn(b, s, e)
    i_in, f_in = rn(b, s, h, scale=2.0), rn(b, s, h, scale=2.0) + 1.0
    r = rn(h, d, d, scale=0.1)
    if ties:  # as test_gate_ties_split_the_gradient_as_the_reference
        i_in[:, 0] = 0.0  # n_1 == 1 from a zero state
        i_in[:, 2] = 10.0  # the clip's tie
    if zero_state:
        c0, n0, h0 = torch.zeros(b, e), torch.zeros(b, h), torch.zeros(b, e)
    else:
        c0, n0, h0 = rn(b, e), rn(b, h).abs() + 0.5, rn(b, e, scale=0.5)
    return [z_in, i_in, f_in, o_in, r, c0, n0, h0]


def _close(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, k)
        scale = max(w.abs().max().item(), 1e-30)
        assert (g - w).abs().max().item() <= TOL * scale, (what, k, (g - w).abs().max().item(),
                                                            scale)


# (B, S, H, d, zero initial state, a gradient of the final state, exact ties)
CASES = [
    (2, 7, 2, 16, True, False, False),
    (2, 5, 2, 16, True, False, True),  # i_in == 10 and n == 1 exactly
    (1, 6, 3, 32, False, True, False),
    (2, 4, 1, 48, False, True, False),
    (1, 3, 2, 192, True, False, False),  # xlstm-125m's width
    (1, 1, 1, 192, False, True, False),  # a decode step
]


@pytest.mark.parametrize("b,s,h,d,zero_state,with_final,ties", CASES)
def test_reg_forward_order_matches_the_loop(b, s, h, d, zero_state, with_final, ties):
    ins = _inputs(b, s, h, d, seed=10 * d + s, zero_state=zero_state, ties=ties)
    out, saved = reg_forward(*ins)
    want_out, want_saved = slstm_scan_ref(*ins, store=True)
    _close(out, want_out, "outputs")
    _close(saved, want_saved, "saved c, n, z")


@pytest.mark.parametrize("b,s,h,d,zero_state,with_final,ties", CASES)
def test_reg_backward_order_matches_the_closed_form_and_autograd(b, s, h, d, zero_state,
                                                                  with_final, ties):
    ins = _inputs(b, s, h, d, seed=10 * d + s + 1, zero_state=zero_state, ties=ties)
    z_in, i_in, f_in, o_in, r, c0, n0, h0 = ins
    g = torch.Generator().manual_seed(d + s)
    dys = torch.randn(b, s, h * d, generator=g)
    d_final = ((torch.randn(b, h * d, generator=g), torch.randn(b, h, generator=g),
                torch.randn(b, h * d, generator=g)) if with_final else (None, None, None))
    (ys, _, _, _), saved = reg_forward(*ins)
    got = reg_backward(i_in, f_in, o_in, r, c0, n0, saved, dys, *d_final)
    _close(got, slstm_scan_bwd_ref(i_in, f_in, o_in, r, c0, n0, saved, dys, *d_final),
           "closed form")
    if ties:  # the ties were hit: half of dm and of di pass
        n_all = saved[1]
        assert (n_all[:, 0] == 1.0).all() and (i_in[:, 2] == 10.0).all()
    # every input's gradient against autograd of the loop
    leaves = [t.clone().requires_grad_(True) for t in ins]
    outs = slstm_scan_ref(*leaves)
    pairs = [(o, gr) for o, gr in zip(outs, (dys, *d_final)) if gr is not None]
    torch.autograd.backward([o for o, _ in pairs], [gr for _, gr in pairs])
    dz, di, df, do, dc0, dn0, dh0 = got
    _close([dz, di, df, do, slstm_dr(h0, ys, dz, h), dc0, dn0, dh0],
           [t.grad for t in leaves], "autograd")
