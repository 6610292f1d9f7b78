"""The port's DSE engine, its torch search and the numpy modules it
carries over, against the JAX package on the same numpy inputs.

Tolerance: none. The numpy modules are copies of the reference's and the
torch search is exact int64 arithmetic, so every output is held equal:
arrays bit for bit (NaN where both are NaN, same dtype), everything else
with ``==``. The reference's own ``backend='jax'`` fails on this jax
(engine.py imports ``jax.experimental.enable_x64``, which jax 0.9 no
longer has), so the port's ``backend='torch'`` is held against the
reference's ``backend='numpy'``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.analysis import roofline as ref_roofline
from repro.core import analytical as ref_an
from repro.core import dataflow as ref_df
from repro.core import engine as ref_engine
from repro.core import params as ref_params
from repro.core import pricing as ref_pricing
from repro.core.bandwidth import BandwidthSpec as RefBandwidthSpec
from repro.core.ppa import area as ref_area
from repro.core.ppa import constants as ref_C
from repro.core.ppa import power as ref_power
from repro_torch.analysis import roofline
from repro_torch.core import analytical, dataflow, engine, params, pricing
from repro_torch.core.bandwidth import BandwidthSpec
from repro_torch.core.ppa import area, constants, power


def assert_same(a, b, path="result"):
    """``a`` (port) equals ``b`` (reference), recursing into containers."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), path
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            if f.name != "grid":
                assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def _workloads(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(1, 700, n), rng.integers(1, 6000, n),
                     rng.integers(1, 3000, n)], axis=1)


def _grids(mod):
    """Seeded grids in one module's own DesignGrid: a searched grid with
    every dataflow, tech and fold, an invalid budget (1 MAC over 8
    tiers) and a DRAM-capped spec; an explicit-shape grid."""
    wl = np.concatenate([_workloads(0, 9), [[64, 12100, 147], [1, 1, 1]]])
    budgets = np.array([1, 7, 2**10, 2**14, 2**18] * 4)
    tiers = np.repeat([1, 2, 5, 8], 5)
    P = budgets.size
    point = dict(dataflow=np.array(["os", "dos", "ws", "is"] * 5)[:P],
                 tech=np.array(["2d", "tsv", "miv", "tsv", "miv"] * 4),
                 fold=np.array(["m", "k", "n", "k"] * 5))
    searched = mod.DesignGrid(workloads=wl, tiers=tiers, mac_budgets=budgets, **point)
    explicit = mod.DesignGrid.explicit(wl, rows=np.array([1, 8, 33, 128]),
                                       cols=np.array([1, 16, 70, 128]),
                                       tiers=np.array([1, 2, 3, 16]), tech="tsv")
    return {"searched": searched, "explicit": explicit}


_SPECS = {"none": None, "dram_capped": dict(dram_gbs=16.0, sram_kib_per_tier=256.0,
                                            vlink_bits_per_mac="derived")}


@pytest.mark.parametrize("grid", ["searched", "explicit"])
@pytest.mark.parametrize("spec", list(_SPECS))
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_evaluate_matches_reference(grid, spec, backend):
    kw = dict(backend=backend, device="cpu") if backend == "torch" else {}
    sp = _SPECS[spec]
    got = engine.evaluate(_grids(engine)[grid], bandwidth=sp and BandwidthSpec(**sp), **kw)
    want = ref_engine.evaluate(_grids(ref_engine)[grid], bandwidth=sp and RefBandwidthSpec(**sp))
    assert_same(got, want)
    assert got.cycles.size == want.cycles.size > 0


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_evaluate_transient_matches_reference(backend):
    kw = dict(backend=backend, device="cpu") if backend == "torch" else {}
    wl = _workloads(1, 4)
    got = engine.evaluate(engine.DesignGrid.product(wl, [2**12, 2**16], [1, 4]),
                          thermal="transient", **kw)
    want = ref_engine.evaluate(ref_engine.DesignGrid.product(wl, [2**12, 2**16], [1, 4]),
                               thermal="transient")
    assert_same(got, want)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("policies", [("per_layer", "fixed"), ("per_layer", "fixed", "tier_fold")])
def test_schedule_matches_reference(backend, policies):
    kw = dict(backend=backend, device="cpu") if backend == "torch" else {}
    wl = _workloads(2, 6)
    stream = types.SimpleNamespace(workloads=wl, counts=np.arange(1, 7, dtype=np.float64),
                                   arch="seeded", shape="s", mode="infer")
    bw = dict(dram_gbs=64.0)
    got = engine.schedule(stream, tiers=(1, 2, 4, 8), bandwidth=BandwidthSpec(**bw),
                          policies=policies, **kw)
    want = ref_engine.schedule(stream, tiers=(1, 2, 4, 8), bandwidth=RefBandwidthSpec(**bw),
                               policies=policies)
    assert_same(got.to_dict(), want.to_dict())


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_optimal_tiers_and_thermal_feasible_match_reference(backend):
    kw = dict(backend=backend, device="cpu") if backend == "torch" else {}
    wl = _workloads(3, 20)
    assert_same(engine.optimal_tiers_batched(wl, [2**14, 2**16, 2**18], **kw),
                ref_engine.optimal_tiers_batched(wl, [2**14, 2**16, 2**18]))
    assert_same(engine.thermal_feasible(wl, [2**14, 2**18], [1, 12], **kw),
                ref_engine.thermal_feasible(wl, [2**14, 2**18], [1, 12]))


def test_fig5_speedup_on_torch_backend():
    """The 12-tier speedup at 2^18 MACs and K 12100 (Fig. 5's headline)."""
    wl = [(64, k, 147) for k in (255, 2560, 12100)]
    budgets, tiers = [2**12, 2**14, 2**16, 2**18], range(1, 17)
    got = engine.evaluate(engine.DesignGrid.product(wl, budgets, tiers), metrics=("perf",),
                          backend="torch", device="cpu")
    want = ref_engine.evaluate(ref_engine.DesignGrid.product(wl, budgets, tiers),
                               metrics=("perf",))
    assert_same(got, want)
    assert round(float(got.speedup[2, 3 * 16 + 11]), 2) == 9.57


def _search_inputs(seed, n, big=False):
    rng = np.random.default_rng(seed)
    hi = 2**53 if big else 5000
    D1 = rng.integers(1, 300, n)
    D2 = rng.integers(1, hi, n)
    Tser = rng.integers(1, hi, n)
    budget = rng.integers(1, 2**18, n)
    return [np.asarray(x, np.int64) for x in (D1, D2, Tser, budget)]


@pytest.mark.parametrize("big", [False, True])
def test_torch_search_equals_numpy_search(big):
    """``_search_rc_torch`` against ``_search_rc(np, ...)``: the float64
    fast path below 2^52, and (big) dims above 2^52 that force numpy's
    int64 path."""
    D1, D2, Tser, budget = _search_inputs(4, 400, big)
    r_max = int(np.minimum(D1, budget).max())
    want = ref_an._search_rc(np, D1, D2, Tser, budget, r_max)
    got = analytical._search_rc_torch(*(torch.from_numpy(x) for x in (D1, D2, Tser, budget)),
                                      r_max)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        assert np.array_equal(g.numpy(), w)


def test_torch_search_ties_break_on_the_first_minimum():
    """D1 = D2 = 1 makes every R valid up to the budget's width only at
    R = 1; D1 = 4, budget 4: R = 2 (C 2) and R = 4 (C 1) both take
    (2*R2 + C2 + T - 2) * folds cycles; the first (smallest R) wins in
    both searches. R beyond min(D1, budget) is masked with
    INVALID_CYCLES, which must never be chosen."""
    D1 = np.array([1, 4, 6, 12, 3], np.int64)
    D2 = np.array([1, 4, 6, 12, 9], np.int64)
    Tser = np.array([1, 3, 1, 5, 1], np.int64)
    budget = np.array([1, 4, 6, 12, 1], np.int64)
    r_max = 16  # wider than every point: the tail is all INVALID_CYCLES
    want = ref_an._search_rc(np, D1, D2, Tser, budget, r_max)
    got = analytical._search_rc_torch(*(torch.from_numpy(x) for x in (D1, D2, Tser, budget)),
                                      r_max)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert (got[2].numpy() < analytical.INVALID_CYCLES).all()


def test_optimize_rc_batched_torch_invalid_budgets_and_int64():
    """Budgets below one MAC per tier read INVALID_CYCLES in both; K of
    2^55 pushes tau past 2^53, where numpy reruns the chunk in int64."""
    M = np.array([64, 64, 7, 300])
    K = np.array([12100, 2**55, 5, 7])
    N = np.array([147, 3, 9, 2**40])
    n_macs = np.array([2**14, 2**10, 3, 2**12])
    tiers = np.array([4, 2, 8, 3])
    got = analytical.optimize_rc_batched(M, K, N, n_macs, tiers, backend="torch", device="cpu")
    want = ref_an.optimize_rc_batched(M, K, N, n_macs, tiers)
    assert_same(got, want)
    assert got[2][2] == analytical.INVALID_CYCLES and got[2][1] > 2**53


def test_torch_backend_needs_a_card(monkeypatch):
    """``backend='torch'`` with no device means the card, and raises
    without one: it never runs numpy instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid = engine.DesignGrid.product([(64, 256, 64)], [2**10], [1, 2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.evaluate(grid, backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.optimal_tiers_batched([(64, 256, 64)], [2**10], backend="torch")
    with pytest.raises(ValueError, match="backend='torch' only"):
        engine.evaluate(grid, device="cpu")


@pytest.mark.parametrize("shard,backend,error", [
    (2, "numpy", ValueError), (2, "torch", ValueError), ("auto", "torch", None),
    ("none", "numpy", None)])
def test_shard_requests(shard, backend, error):
    grid = engine.DesignGrid.product([(64, 256, 64)], [2**10], [1, 2])
    kw = dict(backend=backend, shard=shard, metrics=("perf",))
    if backend == "torch":
        kw["device"] = "cpu"
    if error:
        with pytest.raises(error):
            engine.evaluate(grid, **kw)
    else:
        assert_same(engine.evaluate(grid, **kw),
                    ref_engine.evaluate(ref_engine.DesignGrid.product([(64, 256, 64)], [2**10],
                                                                      [1, 2]), metrics=("perf",)))


def test_constants_and_vocabularies_match_reference():
    names = [n for n in dir(ref_C) if n.isupper()]
    assert names and all(getattr(constants, n) == getattr(ref_C, n) for n in names)
    for n in dir(ref_params):
        if n.startswith("VALID_") and n != "VALID_BACKENDS":
            assert getattr(params, n) == getattr(ref_params, n), n
    assert params.VALID_BACKENDS == ("numpy", "torch")


def test_table2_power_matches_reference():
    setup = power.table2_setup()
    assert_same(setup, ref_power.table2_setup())
    got = [power.array_power(**setup[t]) for t in ("2d", "tsv", "miv")]
    assert_same(got, [ref_power.array_power(**setup[t]) for t in ("2d", "tsv", "miv")])
    assert [round(r.total_w, 2) for r in got] == [6.61, 6.39, 6.26]


def _steps(seed, n=40):
    rng = np.random.default_rng(seed)
    return dict(M=rng.integers(0, 600, n), K=rng.integers(1, 5000, n),
                N=rng.integers(1, 3000, n), rows=rng.integers(1, 129, n),
                cols=rng.integers(1, 129, n), tiers=rng.integers(1, 17, n),
                tech=rng.choice(["2d", "tsv", "miv"], n))


@pytest.mark.parametrize("dataflow_", ["os", "dos", "ws", "is"])
@pytest.mark.parametrize("fold", [None, "m", "n"])
def test_price_steps_and_batched_models_match_reference(dataflow_, fold):
    s = _steps(5)
    bw = dict(dram_gbs=32.0, sram_kib_per_tier=512.0)
    got = pricing.price_steps(dataflow_, *s.values(), BandwidthSpec(**bw), freq_hz=0.7e9,
                              vdd_v=0.8, fold=fold)
    want = ref_pricing.price_steps(dataflow_, *s.values(), RefBandwidthSpec(**bw),
                                   freq_hz=0.7e9, vdd_v=0.8, fold=fold)
    assert_same(got, want)
    geo = [s[k] for k in ("M", "K", "N", "rows", "cols", "tiers")]
    assert_same(dataflow.activity_batched(*geo, dataflow=dataflow_),
                ref_df.activity_batched(*geo, dataflow=dataflow_))
    assert_same(power.array_power_batched(*geo, s["tech"], dataflow=dataflow_),
                ref_power.array_power_batched(*geo, s["tech"], dataflow=dataflow_))
    n_total = s["rows"] * s["cols"] * s["tiers"]
    assert_same(area.array_area_um2_batched(n_total, s["tiers"], s["tech"]),
                ref_area.array_area_um2_batched(n_total, s["tiers"], s["tech"]))


def test_roofline_terms_match_reference():
    rng = np.random.default_rng(6)
    c, m, o = rng.uniform(0, 1e-3, (3, 50))
    assert_same(roofline.roofline_terms_batched(c, m, o),
                ref_roofline.roofline_terms_batched(c, m, o))
    assert_same(roofline.roofline_terms_batched(c, m, 0.0),
                ref_roofline.roofline_terms_batched(c, m, 0.0))
