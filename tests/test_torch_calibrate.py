"""The port's calibration harness against the JAX package's, on the CPU.

- ``shape_grid``, the row builders and ``fit_rows`` are numpy copies:
  equal rows, and on identical measured rows a JSON-identical artifact,
  identical fitted rates, overheads and errors.
- ``_build_inputs`` draws the same numbers from the same seed: equal
  inputs, bit for bit (bf16 GEMM operands included).
- ``_kernel_fn``'s outputs on the smoke rows against the reference's (on
  the CPU both run their plain versions): the GEMM in bf16 out, one bf16
  step apart at most (2**-7 of each entry: both round f32 sums that
  differ in their last bits, from the summation order, to bf16) plus
  1e-5 of max|ref|; attention, prefill and decode, 1e-5 absolute
  (f32 math on both sides, O(1) outputs); the SSD scan at the reference
  tests' rtol 1e-3, atol 1e-4 (the chunked form sums in another order).
- ``measure_row`` on the CPU returns the reference's keys and positive
  times.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibrate as ref_cal
from repro_torch.core import calibrate as cal
from repro_torch.kernels import launch_counts


@pytest.mark.parametrize("preset", ["smoke", "default", "full"])
@pytest.mark.parametrize("families,holdout", [(("gemm", "attention", "ssm"), 4),
                                              (("ssm", "gemm"), 2), (("attention",), 0)])
def test_shape_grid_matches_reference(preset, families, holdout):
    kw = dict(families=families, preset=preset, holdout_every=holdout)
    got = cal.shape_grid(cal.CalibrateSpec(**kw))
    assert got == ref_cal.shape_grid(ref_cal.CalibrateSpec(**kw))
    if len(families) == 3:
        assert len(got) == {"smoke": 5, "default": 23, "full": 30}[preset]


def _measured(spec_mod, preset, seed):
    """Rows of one module's grid with seeded "measured" times: a roofline
    with per-family rates and overheads, times a seeded noise factor."""
    rng = np.random.default_rng(seed)
    rows = spec_mod.shape_grid(spec_mod.CalibrateSpec(preset=preset))
    rate = {"gemm": 4e11, "attention": 9e10, "ssm": 3e10}
    over = {"gemm": 2e-5, "attention": 4e-5, "ssm": 6e-5}
    for r in rows:
        t = max(r["flops"] / rate[r["family"]], r["bytes"] / 6e10) + over[r["family"]]
        r["t_s"] = float(t * rng.uniform(0.8, 1.25))
    return rows


@pytest.mark.parametrize("preset", ["smoke", "default", "full"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fit_rows_on_identical_rows_matches_reference(preset, seed):
    got = cal.fit_rows(_measured(cal, preset, seed), cal.CalibrateSpec(preset=preset))
    want = ref_cal.fit_rows(_measured(ref_cal, preset, seed), ref_cal.CalibrateSpec(preset=preset))
    art, ref_art = got.pop("artifact"), want.pop("artifact")
    assert json.dumps(art.to_dict(), sort_keys=True) == json.dumps(ref_art.to_dict(),
                                                                   sort_keys=True)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    back = cal.CalibratedBandwidth.from_dict(json.loads(json.dumps(art.to_dict())))
    assert back.to_dict() == art.to_dict()
    # run_calibration on pre-recorded rows is the same fit, on no device
    again = cal.run_calibration(cal.CalibrateSpec(preset=preset),
                                measured=_measured(cal, preset, seed))
    assert again["artifact"].to_dict() == art.to_dict()


def _smoke_rows():
    return cal.shape_grid(cal.CalibrateSpec(preset="smoke"))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("i", range(5))
def test_inputs_and_kernel_outputs_match_reference(i):
    row = _smoke_rows()[i]
    mode = row["params"].get("mode", "")
    args = cal._build_inputs(row, seed=3, device="cpu")
    ref_args = ref_cal._build_inputs(row, seed=3)
    for a, r in zip(args, ref_args):
        assert np.array_equal(_np(a), _np(r))
        if isinstance(a, torch.Tensor):
            want = torch.bfloat16 if row["family"] == "gemm" else torch.float32
            assert a.dtype == want and str(r.dtype) == str(want).split(".")[-1]
    before = launch_counts()
    got = _np(cal._kernel_fn(row["family"], mode)(*args))
    assert launch_counts() == before  # CPU tensors: plain versions, no launch
    want = np.asarray(ref_cal._kernel_fn(row["family"], mode)(*ref_args).astype(jnp.float32))
    assert got.shape == want.shape
    if row["family"] == "gemm":
        assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want) + 1e-5 * np.abs(want).max())
    elif row["family"] == "attention":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_measure_row_on_cpu():
    rows = _smoke_rows()
    for row in (rows[0], rows[3]):  # a GEMM, a decode row
        got = cal.measure_row(row, reps=3, warmup=1, seed=0, device="cpu")
        want = ref_cal.measure_row(row, reps=1, warmup=0, seed=0)
        assert got.keys() == want.keys()
        assert got["t_s"] > 0 and got["spread_s"] >= 0 and got["reps"] == 3
        assert got["achieved_gflops"] > 0 and got["achieved_gbs"] > 0
        assert {k: got[k] for k in row} == row


def test_measurement_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cal.measure_row(_smoke_rows()[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cal.run_calibration(cal.CalibrateSpec(preset="smoke"))


def test_ssm_flop_count_uses_the_ports_chunk():
    from repro_torch.kernels.ssm_scan import CHUNK

    assert cal._SSM_CHUNK == CHUNK == ref_cal._SSM_CHUNK
