"""The port's attention backward (plain versions, on the CPU) against the
JAX package's flash-2 custom VJP, on the same numpy inputs.

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.chunked import _fwd_impl
from repro.kernels.flash_attention.ops import flash_attention_jnp
from repro_torch.kernels import flash_attention, flash_attention_bwd, launch_counts
from repro_torch.kernels.flash_attention import attention_bwd_ref, attention_fwd_ref, attention_ref

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
