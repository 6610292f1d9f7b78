"""The sLSTM recurrence's plain versions on the CPU: the loop
(``slstm_scan_ref``) and the closed-form backward the kernel computes
(``slstm_scan_bwd_ref`` + ``slstm_dr``).

- The closed-form gradient of every input (z_in, i_in, f_in, o_in, r
  and the initial state c0, n0, h0) against torch autograd of the loop,
  with and without a gradient of the final state, within 1e-5 of each
  gradient's max|ref| (the same f32 math summed in another order); at
  the gates' ties (i_in == 10, n == 1 exactly) both split the gradient in
  halves, as the reference's jnp.minimum and jnp.maximum do.
- ``slstm_scan`` through its autograd Function on CPU tensors (the loop
  forward, the closed-form backward) against the same, launching nothing.
- ``slstm_block`` of the port against ``jax.grad`` of the reference's
  block on the same weights, input and output cotangent, in f32 and at
  the reduced and full head widths (32, 192): the output within 1e-5 and
  every gradient (x and each parameter) within 1e-4 of its max|g|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import xlstm as jax_xlstm
from repro.models.params import materialize as jax_materialize
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import launch_counts, slstm_scan
from repro_torch.kernels.slstm import slstm_dr, slstm_scan_bwd_ref, slstm_scan_ref
from repro_torch.models import xlstm
from repro_torch.models.params import leaves, map_tree

TOL = 1e-5

NAMES = ("z_in", "i_in", "f_in", "o_in", "r", "c0", "n0", "h0")


def _inputs(b, s, h, d, seed, zero_state=False):
    g = torch.Generator().manual_seed(seed)
    e = h * d

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    z_in, o_in = rn(b, s, e), rn(b, s, e)
    i_in, f_in = rn(b, s, h, scale=2.0), rn(b, s, h, scale=2.0) + 1.0
    r = rn(h, d, d, scale=0.1)
    if zero_state:
        c0, n0, h0 = torch.zeros(b, e), torch.zeros(b, h), torch.zeros(b, e)
    else:
        c0, n0, h0 = rn(b, e), rn(b, h).abs() + 0.5, rn(b, e, scale=0.5)
    return [z_in, i_in, f_in, o_in, r, c0, n0, h0]


def _autograd(ins, dys, d_final):
    """Gradients of every input by autograd through the loop."""
    ins = [t.clone().requires_grad_(True) for t in ins]
    outs = slstm_scan_ref(*ins)
    grads_out = [dys] + list(d_final)
    pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
    torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
    return [t.grad for t in ins]


def _closed_form(ins, dys, d_final):
    z_in, i_in, f_in, o_in, r, c0, n0, h0 = ins
    (ys, _, _, _), saved = slstm_scan_ref(*ins, store=True)
    dz, di, df, do, dc0, dn0, dh0 = slstm_scan_bwd_ref(i_in, f_in, o_in, r, c0, n0, saved, dys,
                                                       *d_final)
    return [dz, di, df, do, slstm_dr(h0, ys, dz, r.shape[0]), dc0, dn0, dh0]


def _assert_close(got, want, tol=TOL):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        scale = max(w.abs().max().item(), 1e-30)
        assert (g - w).abs().max().item() <= tol * scale, (name, (g - w).abs().max().item(),
                                                            scale)


CASES = [  # (B, S, H, d, zero initial state, a gradient of the final state)
    (2, 17, 4, 32, True, False),  # training: zeros in, the final state dropped
    (2, 9, 3, 16, False, True),  # decode-like: a state in, its gradient out
    (1, 1, 2, 8, False, True),  # one step
    (3, 40, 1, 5, False, False),  # one head, a ragged width
]


@pytest.mark.parametrize("b,s,h,d,zero_state,with_final", CASES)
def test_closed_form_backward_matches_autograd_of_the_loop(b, s, h, d, zero_state, with_final):
    ins = _inputs(b, s, h, d, seed=b * 100 + s, zero_state=zero_state)
    g = torch.Generator().manual_seed(7)
    dys = torch.randn(b, s, h * d, generator=g)
    d_final = ((torch.randn(b, h * d, generator=g), torch.randn(b, h, generator=g),
                torch.randn(b, h * d, generator=g)) if with_final else (None, None, None))
    _assert_close(_closed_form(ins, dys, d_final), _autograd(ins, dys, d_final))


def test_gate_ties_split_the_gradient_as_the_reference():
    """i_in == 10 exactly, and n == 1 exactly (n0 = 0, i_in = 0 at the
    first step: n_1 = i = exp(0) = 1): both halve the gradient there, in
    autograd of the loop (torch.minimum/maximum) and in the closed form."""
    b, s, h, d = 2, 5, 2, 4
    ins = _inputs(b, s, h, d, seed=3, zero_state=True)
    ins[1][:, 0] = 0.0  # n_1 == 1
    ins[1][:, 2] = 10.0  # the clip's tie
    dys = torch.randn(b, s, h * d, generator=torch.Generator().manual_seed(8))
    auto = _autograd(ins, dys, (None, None, None))
    _assert_close(_closed_form(ins, dys, (None, None, None)), auto)
    # the convention itself: the reference's primitives and the loop's
    # split the gradient in halves at the tie
    assert float(jax.grad(lambda v: jnp.minimum(v, 10.0))(10.0)) == 0.5
    assert float(jax.grad(lambda v: jnp.maximum(v, 1.0))(1.0)) == 0.5
    for fn, at in ((torch.minimum, 10.0), (torch.maximum, 1.0)):
        v = torch.tensor(at, requires_grad=True)
        fn(v, torch.tensor(at)).backward()
        assert float(v.grad) == 0.5


def test_autograd_function_on_the_cpu_launches_nothing():
    ins = _inputs(2, 12, 2, 16, seed=11)
    dys = torch.randn(2, 12, 32, generator=torch.Generator().manual_seed(4))
    before = launch_counts()
    leaves_in = [t.clone().requires_grad_(True) for t in ins]
    ys, c, n, hl = slstm_scan(*leaves_in)
    torch.autograd.backward([ys], [dys])
    assert launch_counts() == before
    want = _autograd(ins, dys, (None, None, None))
    _assert_close([t.grad for t in leaves_in], want)
    plain = slstm_scan_ref(*ins)
    for got, ref in zip((ys, c, n, hl), plain):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_no_steps_leave_the_state():
    ins = _inputs(2, 0, 2, 4, seed=1)
    ys, c, n, hl = slstm_scan(*ins)
    assert ys.shape == (2, 0, 8)
    for got, want in zip((c, n, hl), ins[5:]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _block_grads_jax(jcfg, p_np, x, gy):
    def f(p, x):
        y, _ = jax_xlstm.slstm_block(p, x, jcfg, mode="train")
        return jnp.sum(y * gy)

    p = jax.tree.map(jnp.asarray, p_np)
    y, _ = jax_xlstm.slstm_block(p, jnp.asarray(x), jcfg, mode="train")
    gp, gx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))
    return np.asarray(y), {"x": np.asarray(gx), **{k: np.asarray(v) for k, v in gp.items()}}


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_slstm_block_gradients_match_jax_grad(width):
    """The port's block (closed-form backward on the CPU) against
    ``jax.grad`` of the reference's block, f32, a random cotangent."""
    if width == "reduced":
        jcfg, cfg = jax_reduced(jax_get_config("xlstm-125m")), reduced(get_config("xlstm-125m"))
        b, s = 2, 24
    else:  # the full model's head width d 192, in f32, at a short length
        over = dict(compute_dtype="float32", param_dtype="float32")
        jcfg = dataclasses.replace(jax_get_config("xlstm-125m"), **over)
        cfg = dataclasses.replace(get_config("xlstm-125m"), **over)
        b, s = 1, 6
    p_np = jax.tree.map(np.asarray, jax_materialize(jax_xlstm.slstm_defs(jcfg),
                                                    jax.random.PRNGKey(2), jnp.float32))
    rng = np.random.default_rng(9)
    p_np = {k: (v if k not in ("bf", "norm") else
                (1.0 + 0.3 * rng.normal(size=v.shape)).astype(np.float32))
            for k, v in p_np.items()}
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    gy = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    jy, want = _block_grads_jax(jcfg, p_np, x, gy)

    p = map_tree(lambda a: torch.tensor(a, requires_grad=True), p_np)
    xt = torch.tensor(x, requires_grad=True)
    y, _ = xlstm.slstm_block(p, xt, cfg, mode="train")
    torch.autograd.backward(y, torch.from_numpy(gy))
    got = {"x": xt.grad, **{k: t.grad for k, t in p.items()}}
    assert np.abs(y.detach().numpy() - jy).max() <= TOL * np.abs(jy).max()
    assert got.keys() == want.keys()
    for k in want:
        g = got[k].numpy()
        assert np.abs(g - want[k]).max() <= 1e-4 * np.abs(want[k]).max(), k
        assert np.abs(want[k]).max() > 0, k


def test_slstm_state_tree_is_the_reference_layout():
    jcfg, cfg = jax_reduced(jax_get_config("xlstm-125m")), reduced(get_config("xlstm-125m"))
    want = jax.tree.map(np.asarray, jax_xlstm.slstm_init_state(jcfg, 3))
    got = xlstm.slstm_init_state(cfg, 3)
    assert [p for p, _ in leaves(got)] == [p for p, _ in leaves(want)]
    for (_, g), (_, w) in zip(leaves(got), leaves(want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape and not g.any()
