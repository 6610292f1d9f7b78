"""The port's SSD scan (its plain paths, as they run on the CPU) against
the JAX package: ``ssm_scan_ref`` (step by step), the chunked jnp twin
and the Pallas kernel in interpret mode, on the same numpy inputs; the
decode step ``ssm_step_ref``; and the Mamba2 block's pieces (conv, the
``neg_linspace`` init).

Tolerance, f32: rtol 1e-3, atol 1e-4, as the reference's own tests
(tests/test_kernel_ssm.py) hold its chunked paths to the step-by-step
oracle: the chunked form sums in another order and forms exp(la_i -
la_j) from cumulative sums. bf16 u, B, C with f32 ld: the math is f32 on
both sides and y rounds once to bf16; the reference's bf16 band
(3e-2) against its oracle on the same rounded operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan
from repro.kernels.ssm_scan import ssm_scan_chunked_jnp, ssm_scan_ref as jax_ssm_scan_ref
from repro.kernels.ssm_scan.ref import ssm_step_ref as jax_ssm_step_ref
from repro.models.params import ParamDef as JaxParamDef, materialize as jax_materialize
from repro.models.ssm import _causal_conv as jax_causal_conv
from repro_torch.kernels import launch_counts, ssm_scan
from repro_torch.kernels.ssm_scan import CHUNKS, ssm_scan_chunked, ssm_scan_ref, ssm_step_ref
from repro_torch.models.params import ParamDef, materialize
from repro_torch.models.ssm import _causal_conv

RTOL, ATOL = 1e-3, 1e-4


def _mk(bt, s, h, p, n, seed=0, shared_bc=False):
    """Numpy inputs in the reference's distribution; ``shared_bc`` makes
    one B, C per (batch, step), broadcast over the heads (as Mamba2)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(bt, s, h, p)).astype(np.float32)
    ld = -rng.uniform(0.001, 0.3, size=(bt, s, h)).astype(np.float32)
    nb = 1 if shared_bc else h
    B = np.broadcast_to(rng.normal(size=(bt, s, nb, n)), (bt, s, h, n)).astype(np.float32)
    C = np.broadcast_to(rng.normal(size=(bt, s, nb, n)), (bt, s, h, n)).astype(np.float32)
    return u, ld, B, C


def _port_inputs(u, ld, B, C, shared_bc=False, dtype=torch.float32):
    ut, ldt = torch.from_numpy(u).to(dtype), torch.from_numpy(ld)
    if shared_bc:  # the model's layout: an expand over the heads, stride 0
        h = u.shape[2]
        Bt = torch.from_numpy(np.ascontiguousarray(B[:, :, :1])).to(dtype).expand(-1, -1, h, -1)
        Ct = torch.from_numpy(np.ascontiguousarray(C[:, :, :1])).to(dtype).expand(-1, -1, h, -1)
        assert Bt.stride(2) == 0
    else:
        Bt, Ct = torch.from_numpy(B).to(dtype), torch.from_numpy(C).to(dtype)
    return ut, ldt, Bt, Ct


def _close(got, ref, rtol=RTOL, atol=ATOL):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


# bt, s, h, p, n, B/C shared over heads
SHAPES = {
    "2x256x3 P32 N16": (2, 256, 3, 32, 16, False),
    "1x128x1 P64 N32": (1, 128, 1, 64, 32, False),
    "2x64x4 P64 N64": (2, 64, 4, 64, 64, False),
    "ragged S200": (2, 200, 3, 16, 16, False),
    "S below chunk": (2, 20, 3, 16, 16, False),
    "B/C expanded over heads": (2, 96, 4, 64, 64, True),
}


def _jax_variants(u, ld, B, C):
    args = tuple(jnp.asarray(a) for a in (u, ld, B, C))
    return {
        "ssm_scan_ref": jax_ssm_scan_ref(*args),
        "chunked_jnp": jax_ssm_scan(*args, chunk=32),  # pads a ragged S, then the jnp twin
        "pallas_interpret": jax_ssm_scan(*args, chunk=64, interpret=True),
    }


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("chunk", CHUNKS)
def test_plain_scan_matches_reference(shape, chunk):
    bt, s, h, p, n, shared = SHAPES[shape]
    arrays = _mk(bt, s, h, p, n, seed=s + n, shared_bc=shared)
    y, state = ssm_scan_chunked(*_port_inputs(*arrays, shared_bc=shared), chunk=chunk)
    assert y.dtype == torch.float32 and state.dtype == torch.float32
    for name, (ry, rs) in _jax_variants(*arrays).items():
        _close(y, ry)
        _close(state, rs)


def test_chunked_jnp_twin_on_a_divisible_shape():
    """The JAX package's chunked twin called directly (no padding path)."""
    arrays = _mk(2, 128, 2, 32, 16, seed=5)
    ry, rs = ssm_scan_chunked_jnp(*(jnp.asarray(a) for a in arrays), chunk=64)
    y, state = ssm_scan_chunked(*_port_inputs(*arrays), chunk=64)
    _close(y, ry)
    _close(state, rs)


@pytest.mark.parametrize("shape", ["2x64x4 P64 N64", "ragged S200"])
def test_port_step_reference_matches_reference(shape):
    bt, s, h, p, n, shared = SHAPES[shape]
    arrays = _mk(bt, s, h, p, n, seed=7)
    y, state = ssm_scan_ref(*_port_inputs(*arrays))
    ry, rs = jax_ssm_scan_ref(*(jnp.asarray(a) for a in arrays))
    _close(y, ry, rtol=1e-5, atol=1e-5)
    _close(state, rs, rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_runs_the_plain_version():
    arrays = _mk(2, 50, 2, 8, 16, seed=13)
    before = launch_counts()["ssm_scan"]
    y, state = ssm_scan(*_port_inputs(*arrays))
    assert launch_counts()["ssm_scan"] == before  # no kernel on the CPU
    ry, rs = jax_ssm_scan_ref(*(jnp.asarray(a) for a in arrays))
    assert tuple(y.shape) == arrays[0].shape
    _close(y, ry)
    _close(state, rs)


@pytest.mark.parametrize("shared", [False, True])
def test_bf16_inputs_with_f32_log_decay(shared):
    """bf16 u, B, C and f32 ld, as Mamba2 feeds them: y is bf16, the state
    f32, both within the bf16 band of the reference's oracle on the same
    rounded operands."""
    u, ld, B, C = _mk(2, 64, 4, 16, 16, seed=21, shared_bc=shared)
    ut, ldt, Bt, Ct = _port_inputs(u, ld, B, C, shared_bc=shared, dtype=torch.bfloat16)
    y, state = ssm_scan(ut, ldt, Bt, Ct)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    rounded = [jnp.asarray(t.float().contiguous().numpy()) for t in (ut, Bt, Ct)]
    ry, rs = jax_ssm_scan_ref(rounded[0], jnp.asarray(ld), rounded[1], rounded[2])
    _close(y, ry, rtol=3e-2, atol=3e-2)
    _close(state, rs, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("bt,h,p,n", [(1, 1, 1, 1), (2, 3, 8, 4), (3, 4, 64, 64)])
def test_decode_step_matches_reference(bt, h, p, n):
    rng = np.random.default_rng(bt * 100 + n)
    state = rng.normal(size=(bt, h, n, p)).astype(np.float32)
    u_t = rng.normal(size=(bt, h, p)).astype(np.float32)
    ld_t = -rng.uniform(0.001, 0.3, size=(bt, h)).astype(np.float32)
    B_t = rng.normal(size=(bt, h, n)).astype(np.float32)
    C_t = rng.normal(size=(bt, h, n)).astype(np.float32)
    ry, rs = jax_ssm_step_ref(*(jnp.asarray(a) for a in (state, u_t, ld_t, B_t, C_t)))
    y, s = ssm_step_ref(*(torch.from_numpy(a) for a in (state, u_t, ld_t, B_t, C_t)))
    _close(y, ry, rtol=1e-5, atol=1e-5)
    _close(s, rs, rtol=1e-5, atol=1e-5)


def test_scan_then_step_equals_longer_scan():
    """Prefill's state handed to the decode step continues the recurrence."""
    u, ld, B, C = (torch.from_numpy(a) for a in _mk(2, 17, 3, 8, 16, seed=3))
    y_all, s_all = ssm_scan(u, ld, B, C)
    _, s16 = ssm_scan(u[:, :16], ld[:, :16], B[:, :16], C[:, :16])
    y1, s1 = ssm_step_ref(s16, u[:, 16], ld[:, 16], B[:, 16], C[:, 16])
    torch.testing.assert_close(s1, s_all, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(y1, y_all[:, 16], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("s,with_state", [(7, False), (1, True), (2, True)])
def test_causal_conv_matches_reference(s, with_state):
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_state else None
    ry, rs = jax_causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if st is None else jnp.asarray(st))
    y, ns = _causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                         None if st is None else torch.from_numpy(st))
    _close(y, ry, rtol=1e-6, atol=1e-6)
    _close(ns, rs, rtol=0, atol=0)


def test_neg_linspace_init_matches_reference():
    shape, axes = (2, 3, 80), ("g", "l", "ssm_heads")
    ref = jax_materialize({"A": JaxParamDef(shape, axes, init="neg_linspace")},
                          jax.random.PRNGKey(0))["A"]
    got = materialize({"A": ParamDef(shape, axes, init="neg_linspace")},
                      torch.Generator().manual_seed(0))["A"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
