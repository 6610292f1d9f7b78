"""The SSD scan's backward on the CPU: the port's closed-form
``ssm_scan_bwd_ref`` against torch autograd of its own chunked forward
(``ssm_scan_chunked``), and the port's ``ssm_scan_bwd`` and the autograd
Function behind ``ssm_scan`` against ``jax.grad`` of the JAX package's
scan (its chunked jnp twin, which pads a ragged S as the port does), on
the same numpy inputs from a seed.

Tolerances, f32: the closed form against autograd of the same chunked
forward, 1e-5 of each gradient's max|ref| (the same f32 terms summed in
other orders); against the JAX package, 1e-4 of each gradient's max|ref|
(two frameworks' f32 sums and exps; the reference's own chunked paths
are held to its oracle at rtol 1e-3, tests/test_kernel_ssm.py). bf16
operands: the wrapper's casts are checked exactly against the f32
result it rounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan
from repro_torch.kernels import launch_counts, ssm_scan, ssm_scan_bwd
from repro_torch.kernels.ssm_scan import ssm_scan_bwd_ref, ssm_scan_chunked

# bt, s, h, p, n, B/C shared by the heads (a head dim of 1 in the port,
# broadcast_to in the reference)
SHAPES = {
    "ragged S100 P16 N16": (2, 100, 3, 16, 16, False),
    "S below chunk P16 N16 shared": (2, 20, 3, 16, 16, True),
    "S96 P64 N64 shared": (2, 96, 4, 64, 64, True),
    "ragged S70 P1 N96": (1, 70, 2, 1, 96, False),
}


def _mk(bt, s, h, p, n, shared, seed):
    """Inputs as Mamba2 makes them (ld = dt * A, heads from light to heavy
    decay), dy, and d_state, as numpy f32."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(bt, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(bt, s, h))))
    ld = (-dt * np.arange(1, h + 1) * 0.3).astype(np.float32)
    nb = 1 if shared else h
    B = rng.normal(size=(bt, s, nb, n)).astype(np.float32)
    C = rng.normal(size=(bt, s, nb, n)).astype(np.float32)
    dy = rng.normal(size=(bt, s, h, p)).astype(np.float32)
    ds = rng.normal(size=(bt, h, n, p)).astype(np.float32)
    return u, ld, B, C, dy, ds


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jax_grads(u, ld, B, C, dy, ds, chunk):
    """jax.grad of <y, dy> (+ <state, ds>) through the reference's scan,
    B and C broadcast over the heads inside the function."""
    h = u.shape[2]

    def f(u, ld, B, C):
        shape = u.shape[:3] + B.shape[-1:]
        y, state = jax_ssm_scan(u, ld, jnp.broadcast_to(B, shape), jnp.broadcast_to(C, shape),
                                chunk=chunk)
        out = jnp.sum(y * dy)
        return out + jnp.sum(state * ds) if ds is not None else out

    assert B.shape[2] in (1, h)
    return jax.grad(f, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (u, ld, B, C)))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("with_dstate", [False, True])
def test_bwd_ref_matches_autograd_of_the_chunked_scan(shape, chunk, with_dstate):
    bt, s, h, p, n, shared = SHAPES[shape]
    u, ld, B, C, dy, ds = (torch.from_numpy(a) for a in _mk(bt, s, h, p, n, shared, seed=s + n))
    ins = [t.clone().requires_grad_() for t in (u, ld, B, C)]
    y, state = ssm_scan_chunked(ins[0], ins[1], ins[2].expand(-1, -1, h, -1),
                                ins[3].expand(-1, -1, h, -1), chunk)
    loss = (y * dy).sum() + ((state * ds).sum() if with_dstate else 0.0)
    want = torch.autograd.grad(loss, ins)
    got = ssm_scan_bwd_ref(u, ld, B.expand(-1, -1, h, -1), C.expand(-1, -1, h, -1), dy,
                           ds if with_dstate else None, chunk)
    assert all(g.dtype == torch.float32 for g in got)
    got = (got[0], got[1], got[2].sum(2, keepdim=True) if shared else got[2],
           got[3].sum(2, keepdim=True) if shared else got[3])
    for name, g, w in zip(("du", "dld", "dB", "dC"), got, want):
        assert _rel(g.numpy(), w.numpy()) <= 1e-5, name


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("with_dstate", [False, True])
def test_bwd_matches_jax_grad_of_the_reference(shape, chunk, with_dstate):
    bt, s, h, p, n, shared = SHAPES[shape]
    u, ld, B, C, dy, ds = _mk(bt, s, h, p, n, shared, seed=s * 3 + n)
    ds = ds if with_dstate else None
    want = _jax_grads(u, ld, B, C, dy, ds, chunk)
    before = launch_counts()
    got = ssm_scan_bwd(*(torch.from_numpy(a) for a in (u, ld, B, C, dy)),
                       None if ds is None else torch.from_numpy(ds), chunk=chunk)
    assert launch_counts() == before  # the plain version on the CPU
    for name, g, w in zip(("du", "dld", "dB", "dC"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert _rel(g.numpy(), w) <= 1e-4, name


@pytest.mark.parametrize("shape", ["ragged S100 P16 N16", "S96 P64 N64 shared"])
def test_function_gradients_match_jax_grad(shape):
    """Autograd through ``ssm_scan`` (its Function: ssm_scan_chunked, then
    ssm_scan_bwd_ref) with the final state dropped, as training does."""
    bt, s, h, p, n, shared = SHAPES[shape]
    u, ld, B, C, dy, _ = _mk(bt, s, h, p, n, shared, seed=11)
    want = _jax_grads(u, ld, B, C, dy, None, 32)
    ins = [torch.from_numpy(a).requires_grad_() for a in (u, ld, B, C)]
    before = launch_counts()
    y, _ = ssm_scan(*ins)
    y_plain, _ = ssm_scan_chunked(*(t.detach() for t in ins[:2]),
                                  *(t.detach().expand(-1, -1, h, -1) for t in ins[2:]))
    assert torch.equal(y.detach(), y_plain)
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    assert launch_counts() == before
    for name, g, w in zip(("du", "dld", "dB", "dC"), got, want):
        assert _rel(g.numpy(), w) <= 1e-4, name


def test_function_passes_the_final_state_gradient():
    """A loss on the final state reaches the inputs through the Function as
    through ssm_scan_bwd with d_state."""
    u, ld, B, C, dy, ds = (torch.from_numpy(a) for a in _mk(2, 50, 3, 8, 16, True, seed=4))
    ins = [t.clone().requires_grad_() for t in (u, ld, B, C)]
    y, state = ssm_scan(*ins)
    got = torch.autograd.grad((y * dy).sum() + (state * ds).sum(), ins)
    want = ssm_scan_bwd(u, ld, B, C, dy, ds)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("shared", [False, True])
def test_bf16_gradients_are_the_f32_gradients_cast_once(shared):
    """bf16 u, B, C, dy with f32 ld: du, dB and dC are the f32 closed form
    of the same bf16 operands, rounded once (dB and dC summed over the
    heads in f32 first); dld stays f32."""
    u, ld, B, C, dy, _ = (torch.from_numpy(a) for a in _mk(2, 40, 4, 16, 16, shared, seed=9))
    u, B, C, dy = (t.to(torch.bfloat16) for t in (u, B, C, dy))
    du, dld, dB, dC = ssm_scan_bwd(u, ld, B, C, dy)
    assert (du.dtype, dld.dtype, dB.dtype, dC.dtype) == (torch.bfloat16, torch.float32,
                                                         torch.bfloat16, torch.bfloat16)
    h = u.shape[2]
    e = ssm_scan_bwd_ref(u.float(), ld, B.float().expand(-1, -1, h, -1),
                         C.float().expand(-1, -1, h, -1), dy.float())
    eB, eC = ((t.sum(2, keepdim=True) if shared else t) for t in e[2:])
    assert torch.equal(du, e[0].to(torch.bfloat16)) and torch.equal(dld, e[1])
    assert torch.equal(dB, eB.to(torch.bfloat16)) and torch.equal(dC, eC.to(torch.bfloat16))
    assert dB.shape == B.shape and dC.shape == C.shape


def test_no_grad_scan_is_the_plain_scan_with_heads_broadcast():
    """A head dim of 1 in B and C is one B, C for every head."""
    u, ld, B, C, _, _ = (torch.from_numpy(a) for a in _mk(2, 33, 3, 8, 16, True, seed=2))
    y, state = ssm_scan(u, ld, B, C)
    y2, state2 = ssm_scan_chunked(u, ld, B.expand(-1, -1, 3, -1), C.expand(-1, -1, 3, -1))
    assert torch.equal(y, y2) and torch.equal(state, state2)
