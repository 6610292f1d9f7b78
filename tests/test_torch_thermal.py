"""The port's thermal models against the JAX package's, on the CPU.

The grid solve (``solve_stack``, torch) is held to the reference's
``_solve_stack_jit`` with no tolerance: both solve in f32, and the port
forms every sum in the order, and with the fused multiply-adds, that the
reference's compiled loop uses, so the temperatures are bit-identical
and both stop at the same Jacobi iteration. The lumped model and the
transient state are numpy copies: equal outputs.

Fig. 8's configuration (65536 MACs, 3 tiers, TSV) never gets max|dT|
under 1e-5 in f32 and runs to the 200,000-iteration cap (~20 s per
package on the CPU). The reference's report and solved T are computed
once per module (a fixture); one test pins its 69.007 degC, which
``chip_smoke.py`` holds the card to, and one holds the port's CPU
report and T to it bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.ppa import thermal as ref_thermal
from repro_torch.core.ppa import thermal

FIG8 = [(m, t, tech) for m in (4096, 16384, 65536) for t, tech in ((1, "2d"), (3, "tsv"),
                                                                     (3, "miv"))]
CAPPED = (65536, 3, "tsv")
CONVERGENT = [c for c in FIG8 if c != CAPPED]


def _inputs(macs, tiers, tech):
    """The power map and cell area ``thermal_report`` hands the solve."""
    side = int(np.sqrt(macs))
    q, _ = thermal._power_map(128, 300, 128, side, side, tiers, tech)
    a_mac = thermal.C.A_MAC_UM2
    if tech == "tsv":
        a_mac += thermal.C.VLINK_BITS * thermal.C.A_TSV_UM2 * (tiers - 1) / tiers
    elif tech == "miv":
        a_mac += thermal.C.VLINK_BITS * thermal.C.A_MIV_UM2 * (tiers - 1) / tiers
    return q, (macs * a_mac * 1e-6) / (thermal._GRID**2)


@pytest.mark.parametrize("macs,tiers,tech", CONVERGENT)
def test_thermal_report_matches_reference(macs, tiers, tech):
    got = thermal.thermal_report(macs, tiers, tech, device="cpu")
    want = ref_thermal.thermal_report(macs, tiers, tech)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    q, area = _inputs(macs, tiers, tech)
    T, iters = thermal._solve_stack(q, area, tiers, tech, "cpu")
    assert T.dtype == torch.float32 and T.device.type == "cpu"
    assert np.array_equal(T.numpy(), np.asarray(ref_thermal.solve_stack(q, area, tiers, tech)))
    assert 1000 < iters < thermal._MAX_ITERS


@pytest.fixture(scope="module")
def ref_capped():
    """The reference's capped report and the T its ``thermal_report``
    solved (captured from its ``solve_stack``)."""
    solved = []
    original = ref_thermal.solve_stack

    def recorded(*args, **kw):
        solved.append(np.asarray(original(*args, **kw)))
        return solved[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_thermal, "solve_stack", recorded)
        rep = ref_thermal.thermal_report(*CAPPED)
    assert len(solved) == 1
    return rep, solved[0]


def test_capped_configuration_reference_value(ref_capped):
    """The reference stops this one at the iteration cap; its hottest
    cell, which ``chip_smoke.py`` holds the card's solve to."""
    rep, _ = ref_capped
    assert round(rep.t_max_c, 3) == 69.007


def test_capped_configuration_matches_reference(ref_capped, monkeypatch):
    """The port's CPU solve runs to the same cap and gives the reference's
    report and temperatures bit for bit."""
    want, T_want = ref_capped
    solved = []
    original = thermal._solve_stack

    def recorded(*args, **kw):
        solved.append(original(*args, **kw))
        return solved[-1]

    monkeypatch.setattr(thermal, "_solve_stack", recorded)
    got = thermal.thermal_report(*CAPPED, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    (T, iters), = solved
    assert iters == thermal._MAX_ITERS
    assert T.dtype == torch.float32 and np.array_equal(T.numpy(), T_want)


@pytest.mark.parametrize("check_every", [1, 100, 4096])
def test_stop_iteration_does_not_depend_on_how_often_the_flag_is_read(monkeypatch, check_every):
    """The loop freezes T and the count once an iteration's max|dT| is
    under the tolerance, so reading the flag back every iteration or every
    few thousand gives the same iteration and the same bits; a cap that
    falls inside a chunk is honoured exactly."""
    q, area = _inputs(4096, 3, "miv")
    T_ref, it_ref = thermal._solve_stack(q, area, 3, "miv", "cpu")
    monkeypatch.setattr(thermal, "_CHECK_EVERY", check_every)
    T, it = thermal._solve_stack(q, area, 3, "miv", "cpu")
    assert it == it_ref and torch.equal(T, T_ref)
    monkeypatch.setattr(thermal, "_MAX_ITERS", 250)
    T_cap, it_cap = thermal._solve_stack(q, area, 3, "miv", "cpu")
    assert it_cap == 250 and not torch.equal(T_cap, T_ref)


def test_solve_stack_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q, area = _inputs(4096, 1, "2d")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thermal.solve_stack(q, area, 1, "2d")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thermal.thermal_report(4096, 1, "2d")


def test_lumped_and_transient_models_match_reference():
    rng = np.random.default_rng(0)
    B, L = 12, 6
    q = rng.uniform(0.0, 3.0, (B, L))
    foot = rng.uniform(0.5, 40.0, B)
    tiers = rng.integers(1, L + 1, B)
    tech = rng.choice(["2d", "tsv", "miv"], B)
    macs = rng.integers(64, 2**16, B)
    np.testing.assert_array_equal(thermal.lumped_tier_temps(q, foot, tiers, tech, macs),
                                  ref_thermal.lumped_tier_temps(q, foot, tiers, tech, macs))
    st = thermal.ThermalState.init(foot, tiers, tech, macs)
    ref = ref_thermal.ThermalState.init(foot, tiers, tech, macs)
    for dt in (1e-4, rng.uniform(1e-5, 1e-2, B)):
        st, ref = thermal.step_temps(st, q, dt), ref_thermal.step_temps(ref, q, dt)
        for f in dataclasses.fields(st):
            np.testing.assert_array_equal(getattr(st, f.name), getattr(ref, f.name))
    np.testing.assert_array_equal(st.t_max_c, ref.t_max_c)
