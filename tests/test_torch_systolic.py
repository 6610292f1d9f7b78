"""The port's cycle-level systolic simulators against the JAX package's.

Both simulate every PE cycle by cycle in f32 and sum the same products in
the same order; the reference's compiled loop fuses each multiply-add
(one rounding) where the port rounds the product and the sum, so the
outputs agree to a few f32 ulps of the dot products: held at 1e-5 of
max|A @ B| against the reference, and at the reference test's rtol and
atol of 1e-4 (tests/test_systolic.py) against ``A @ B``. Cycle and fold counts are
integers and must be equal.
"""

import numpy as np
import pytest
import torch

from repro.core import systolic as ref_systolic
from repro_torch.core import systolic
from repro_torch.core.analytical import tau_2d, tau_3d

CASES = [  # M, K, N, R, C, tiers: ragged folds on every side
    (5, 7, 3, 2, 2, 1),
    (9, 13, 11, 4, 3, 3),
    (16, 30, 9, 5, 4, 4),
    (3, 1, 2, 3, 2, 2),
    (12, 20, 12, 4, 4, 2),
]


def _operands(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, K)).astype(np.float32),
            rng.normal(size=(K, N)).astype(np.float32))


@pytest.mark.parametrize("M,K,N,R,C,L", CASES)
def test_simulators_match_reference(M, K, N, R, C, L):
    A, B = _operands(M, K, N)
    exact = A.astype(np.float64) @ B.astype(np.float64)
    scale = max(np.abs(exact).max(), 1.0)
    runs = [(systolic.simulate_os_2d(A, B, R, C, device="cpu"),
             ref_systolic.simulate_os_2d(A, B, R, C), tau_2d(M, K, N, R, C), 1),
            (systolic.simulate_dos_3d(A, B, R, C, L, device="cpu"),
             ref_systolic.simulate_dos_3d(A, B, R, C, L), tau_3d(M, K, N, R, C, L), L)]
    for got, want, tau, tiers in runs:
        assert isinstance(got.out, torch.Tensor) and got.out.shape == (M, N)
        assert np.abs(got.out.numpy() - np.asarray(want.out)).max() <= 1e-5 * scale
        np.testing.assert_allclose(got.out.numpy(), exact, rtol=1e-4, atol=1e-4)
        assert got.cycles == want.cycles == int(tau)
        assert (got.folds, got.tiers) == (want.folds, want.tiers) == (want.folds, tiers)


def test_simulators_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, B = _operands(4, 4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        systolic.simulate_os_2d(A, B, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        systolic.simulate_dos_3d(A, B, 2, 2, 2)


def test_mismatched_inner_dims_raise():
    A, B = _operands(4, 5, 4)
    with pytest.raises(ValueError, match="inner dims"):
        systolic.simulate_os_2d(A, B[:4], 2, 2, device="cpu")
