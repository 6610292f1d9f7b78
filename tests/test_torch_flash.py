"""The port's attention (its plain paths, as they run on the CPU) against
the JAX package: the Pallas flash kernel in interpret mode on divisible
shapes, ``attention_ref`` and ``flash_attention_jnp`` on ragged ones
(where the Pallas path asserts), and ``decode_attention`` on the cases
``tests/test_kernel_flash.py`` pins. Same numpy inputs on both sides.

Tolerance, f32: 2e-5 absolute. Outputs are convex mixtures of v rows,
so they are O(1); both sides compute in f32 and differ only in the
order of their sums. bf16 inputs: the math is f32 on both sides and the
output rounds once to bf16, so they agree to one bf16 ulp (2**-7 of
each entry).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import decode_attention as jax_decode_attention
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ops import flash_attention_jnp
from repro_torch.kernels.flash_attention import (
    attention_ref, decode_attention, flash_attention,
)

F32_TOL = 2e-5


def _mk(b, sq, skv, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))


def _port(fn, arrays, dtype=torch.float32, **kw):
    return fn(*(torch.from_numpy(a).to(dtype) for a in arrays), **kw).float().numpy()


def _jax(fn, arrays, dtype="float32", **kw):
    return np.asarray(fn(*(jnp.asarray(a, dtype) for a in arrays), **kw), np.float32)


# b, sq, skv, h, kvh, d, causal, window, q_offset
DIVISIBLE = [
    (2, 128, 128, 4, 2, 64, True, None, 0),
    (1, 128, 128, 9, 3, 64, True, None, 0),     # smollm's 9/3 grouping
    (1, 128, 128, 8, 1, 64, True, None, 0),     # h >> kvh
    (2, 128, 256, 4, 4, 32, False, None, 0),    # h == kvh, no mask
    (1, 256, 256, 4, 4, 32, True, 64, 0),       # sliding window
    (1, 128, 256, 4, 2, 32, True, None, 128),   # queries at the end
]


@pytest.mark.parametrize("case", DIVISIBLE)
def test_plain_matches_pallas_interpret(case):
    b, sq, skv, h, kvh, d, causal, window, q_offset = case
    arrs = _mk(b, sq, skv, h, kvh, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ref = _jax(jax_flash_attention, arrs, interpret=True, **kw)
    np.testing.assert_allclose(_port(flash_attention, arrs, **kw), ref, rtol=0, atol=F32_TOL)


RAGGED = [
    (1, 200, 200, 9, 3, 64, True, None, 0),
    (2, 200, 200, 4, 1, 32, True, 48, 0),
    (1, 72, 200, 4, 2, 32, True, None, 128),
    (2, 200, 130, 4, 4, 128, False, None, 0),
    (1, 200, 200, 4, 1, 256, True, 2**30, 0),  # the global sentinel as an int
]


@pytest.mark.parametrize("case", RAGGED)
def test_ragged_matches_ref_and_jnp(case):
    b, sq, skv, h, kvh, d, causal, window, q_offset = case
    arrs = _mk(b, sq, skv, h, kvh, d, seed=1)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = _port(flash_attention, arrs, **kw)
    np.testing.assert_allclose(out, _jax(jax_attention_ref, arrs, **kw), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(out, _jax(flash_attention_jnp, arrs, chunk=64, **kw),
                               rtol=0, atol=F32_TOL)


def test_bf16_inputs():
    arrs = _mk(2, 200, 200, 9, 3, 64, seed=2)
    kw = dict(causal=True, window=32)
    ref = _jax(jax_attention_ref, arrs, "bfloat16", **kw)
    out = _port(flash_attention, arrs, torch.bfloat16, **kw)
    assert np.all(np.abs(out - ref) <= 2.0**-7 * np.abs(ref) + 1e-6)


def test_rows_without_visible_keys_match_ref():
    """window=0 hides every key: the reference gives mean(v) per row."""
    arrs = _mk(1, 70, 70, 2, 1, 32, seed=3)
    out = _port(attention_ref, arrs, causal=True, window=0)
    np.testing.assert_allclose(out, _jax(jax_attention_ref, arrs, causal=True, window=0),
                               rtol=0, atol=F32_TOL)
    want = np.repeat(arrs[2].mean(axis=1, keepdims=True), 70, axis=1)
    np.testing.assert_allclose(out[..., 0, :], want[..., 0, :], rtol=0, atol=F32_TOL)


def test_cpu_path_launches_no_kernel():
    before = flash_attention.launches
    _port(flash_attention, _mk(1, 8, 8, 2, 1, 32))
    assert flash_attention.launches == before


# --- decode_attention -------------------------------------------------------


def _mk_decode(b=2, s=64, h=4, kvh=2, d=32, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 1, h, d)).astype(np.float32),
            rng.normal(size=(b, s, kvh, d)).astype(np.float32),
            rng.normal(size=(b, s, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("length,window", [
    (40, None), (40, 16), (40, 1), (1, None), (64, 64),
    (0, None),                 # empty cache: exact zeros
    (8, 0),                    # a window that excludes even the newest slot
    ((40, 17), None),          # per-batch lengths
    ((0, 8), None),            # one row empty, one live
    ((40, 17), 16),
])
def test_decode_matches_reference(length, window):
    arrs = _mk_decode()
    t_len = length if isinstance(length, int) else torch.tensor(length)
    j_len = length if isinstance(length, int) else jnp.asarray(length)
    out = _port(decode_attention, arrs, length=t_len, window=window)
    ref = _jax(jax_decode_attention, arrs, length=j_len, window=window)
    np.testing.assert_allclose(out, ref, rtol=0, atol=F32_TOL)
    lengths = np.broadcast_to(np.asarray(length), (2,))
    for i, n in enumerate(lengths):
        if n == 0 or window == 0:
            assert np.all(out[i] == 0.0)


def test_decode_window_includes_newest_slot():
    """window=1 attends to exactly slot length-1: the output is that v row."""
    q, kc, vc = _mk_decode()
    out = _port(decode_attention, (q, kc, vc), length=40, window=1)
    want = np.repeat(vc[:, 39], 2, axis=1).reshape(2, 1, 4, 32)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)


def test_decode_bf16_cache():
    arrs = _mk_decode(s=64)
    out = _port(decode_attention, arrs, torch.bfloat16, length=40, window=24)
    ref = _jax(jax_decode_attention, arrs, "bfloat16", length=40, window=24)
    assert np.all(np.abs(out - ref) <= 2.0**-7 * np.abs(ref) + 1e-6)
