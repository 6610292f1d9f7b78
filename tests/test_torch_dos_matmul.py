"""The port's dOS matmul (its plain path, as it runs on the CPU) against
the JAX package: the Pallas kernel in interpret mode, ``matmul_ref`` and
the tier-ordered ``dos_matmul_ref``. Same numpy inputs on both sides.

Tolerance, f32: max|diff| <= 1e-5 * max|ref|. XLA and torch sum K in
different orders, so the results are not bit-equal; an indexing or
masking fault gives errors of the order of max|ref| itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dos_matmul import dos_matmul as jax_dos_matmul
from repro.kernels.dos_matmul import dos_matmul_ref as jax_dos_matmul_ref
from repro.kernels.dos_matmul import matmul_ref as jax_matmul_ref
from repro_torch.kernels.dos_matmul import dos_matmul, dos_matmul_ref, matmul_ref

F32_TOL = 1e-5

SHAPES = [
    (128, 256, 128),  # divisible
    (100, 300, 77),   # non-divisible on every side
    (130, 384, 200),
    (4, 576, 192),    # the decode step's M = 4
    (3, 64, 40),      # degenerate: M < 8, K < 128, N < 128
    (1, 17, 64),
]


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed + m * 7 + k * 3 + n)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def _close(out, ref, tol=F32_TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_pallas_interpret(m, k, n):
    a, b = _inputs(m, k, n)
    ref = jax_dos_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    out = dos_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32
    _close(out.numpy(), ref)
    _close(matmul_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
           jax_matmul_ref(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("n_tiers", [1, 2, 4, 8])
def test_tier_ordered_ref(n_tiers):
    a, b = _inputs(64, 512, 96, seed=1)
    ref = jax_dos_matmul_ref(jnp.asarray(a), jnp.asarray(b), n_tiers=n_tiers)
    out = dos_matmul_ref(torch.from_numpy(a), torch.from_numpy(b), n_tiers=n_tiers)
    _close(out.numpy(), ref)
    _close(out.numpy(), a.astype(np.float64) @ b)


def test_tier_ref_rejects_uneven_split():
    a, b = _inputs(8, 30, 8)
    with pytest.raises(ValueError):
        dos_matmul_ref(torch.from_numpy(a), torch.from_numpy(b), n_tiers=4)


@pytest.mark.parametrize("lead", [(2,), (3, 5)])
def test_leading_dims_flatten_into_m(lead):
    rng = np.random.default_rng(2)
    a = rng.normal(size=lead + (16, 128)).astype(np.float32)
    b = rng.normal(size=(128, 33)).astype(np.float32)
    ref = jax_dos_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    out = dos_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(out.shape) == lead + (16, 33)
    _close(out.numpy(), ref)


def test_transposed_view_operand():
    """The tied unembedding multiplies by ``tok.T``, a strided view."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(20, 64)).astype(np.float32)
    tok = rng.normal(size=(300, 64)).astype(np.float32)
    ref = jax_dos_matmul(jnp.asarray(a), jnp.asarray(tok).T, interpret=True)
    out = dos_matmul(torch.from_numpy(a), torch.from_numpy(tok).T)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_bf16_out_dtype(in_dtype):
    """bf16 output: both sides sum in f32 and round once to bf16; sums
    that differ in the last f32 bits may round to neighbouring bf16
    values, so they agree to one bf16 ulp (2**-7 of each entry)."""
    a, b = _inputs(130, 256, 72, seed=4)
    ja, jb = jnp.asarray(a, in_dtype), jnp.asarray(b, in_dtype)
    ta, tb = (torch.from_numpy(x).to(getattr(torch, in_dtype)) for x in (a, b))
    ref = np.asarray(jax_dos_matmul(ja, jb, interpret=True, out_dtype=jnp.bfloat16),
                     np.float32)
    out = dos_matmul(ta, tb, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    tol = 2.0**-7 * np.abs(ref) + F32_TOL * np.abs(ref).max()
    assert np.all(np.abs(out - ref) <= tol)


def test_cpu_path_launches_no_kernel():
    before = dos_matmul.launches
    a, b = _inputs(8, 16, 8)
    dos_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert dos_matmul.launches == before
