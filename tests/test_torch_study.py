"""The port's Study front door against the JAX package's, on the CPU.

Every module behind it (``study``, ``cache``, ``dse``, ``advisor``,
``search``, ``serve``, ``network``) is a numpy copy of the reference's,
and the torch backend's search returns the numpy backend's integers, so
every comparison here is exact equality, of the JSON form of the
artifact's payload (``_jsonify``):

- every ``ANALYSIS_KINDS`` entry, from the reference's
  ``Study.example(kind)`` (and its transient variant where the kind
  takes one), at ``backend="numpy"`` and at ``backend="torch",
  device="cpu"``; ``calibrate`` from the same pre-recorded ``measured``
  rows loaded into each package's cache, so nothing is timed;
- ``study_hash`` of each spec, whatever its execution knobs;
- the cache: a re-run (``--resume``) reuses every chunk; a calibrate
  chunk stored for one device is not replayed for another;
- the CLI (``python -m repro_torch``): ``example-spec KIND | run -
  --device cpu`` in subprocesses, ``--resume``, and ``bench`` raising;
- the paper-figure builders and shims of ``dse`` (Fig. 5's 9.57x and
  Fig. 7's medians 2/4/7 through the port's Study) and the advisor.
"""

import dataclasses
import functools
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import advisor as ref_advisor
from repro.core import calibrate as ref_cal
from repro.core import dse as ref_dse
from repro.core import study as ref_study
from repro.core.cache import ResultCache as RefCache
from repro.core.cache import study_hash as ref_hash
from repro_torch import cli
from repro_torch.core import advisor, dse, study
from repro_torch.core import calibrate as cal
from repro_torch.core.cache import DEFAULT_CACHE_DIR, ResultCache, study_hash

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = [k for k in ref_study.ANALYSIS_KINDS if k != "calibrate"]
TRANSIENT_KINDS = ("evaluate", "pareto", "roofline", "schedule", "serve")
CASES = [(k, False) for k in KINDS] + [(k, True) for k in TRANSIENT_KINDS]
BACKENDS = [{"backend": "numpy"}, {"backend": "torch", "device": "cpu"}]


def _ref_example(kind, transient=False):
    s = ref_study.Study.example(kind)
    if transient:
        s = dataclasses.replace(
            s, name=s.name + "-transient",
            analysis=dataclasses.replace(s.analysis, thermal="transient"))
    return s


def _port(ref, **analysis):
    """The port's Study of the reference's spec, with execution knobs."""
    d = ref.to_dict()
    d["analysis"].update(analysis)
    return study.Study.from_dict(d)


def _payload(result) -> dict:
    return result.to_dict()["payload"]


@functools.lru_cache(maxsize=None)
def _ref_run(kind, transient):
    r = _ref_example(kind, transient).run()
    return _payload(r), r.describe()


@pytest.mark.parametrize("kw", BACKENDS, ids=["numpy", "torch-cpu"])
@pytest.mark.parametrize("kind,transient", CASES)
def test_every_kind_matches_reference(kind, transient, kw):
    ref = _ref_example(kind, transient)
    got = _port(ref, **kw).run()
    want, describe = _ref_run(kind, transient)
    assert _payload(got) == want
    assert got.describe() == describe
    # the artifact round-trips, and the reference's artifact loads in the port
    back = study.StudyResult.from_json(got.to_json())
    assert _payload(back) == want and back.study == got.study
    assert _payload(study.StudyResult.from_json(ref.run().to_json())) == want


@pytest.mark.parametrize("kind,transient",
                         CASES + [("calibrate", False)])
def test_study_hash_matches_reference(kind, transient):
    ref = _ref_example(kind, transient)
    want = ref_hash(ref)
    assert study_hash(_port(ref)) == want
    for knobs in ({"backend": "torch"}, {"backend": "torch", "device": "cpu", "workers": 3},
                  {"backend": "torch", "device": "cuda:1", "chunk": 64}):
        assert study_hash(_port(ref, **knobs)) == want, knobs
    assert study_hash(dataclasses.replace(_port(ref), name="renamed")) == want


def _recorded_rows(preset, seed=0):
    """``measure_row``-shaped records with seeded times (a roofline with
    per-family rates and overheads times a noise factor)."""
    rng = np.random.default_rng(seed)
    rate = {"gemm": 4e11, "attention": 9e10, "ssm": 3e10}
    over = {"gemm": 2e-5, "attention": 4e-5, "ssm": 6e-5}
    out = []
    for row in ref_cal.shape_grid(ref_cal.CalibrateSpec(preset=preset)):
        t = max(row["flops"] / rate[row["family"]], row["bytes"] / 6e10) + over[row["family"]]
        t = float(t * rng.uniform(0.8, 1.25))
        out.append(dict(row, t_s=t, spread_s=t * 0.01, reps=3,
                        achieved_gflops=row["flops"] / t / 1e9,
                        achieved_gbs=row["bytes"] / t / 1e9))
    return out


def _calibrate_ref_spec(preset):
    s = ref_study.Study.example("calibrate")
    return dataclasses.replace(s, analysis=dataclasses.replace(
        s.analysis, calibrate=ref_cal.CalibrateSpec(preset=preset, reps=2, warmup=1)))


@pytest.mark.parametrize("preset", ["smoke", "default"])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_calibrate_from_recorded_rows_matches_reference(tmp_path, preset, backend):
    ref = _calibrate_ref_spec(preset)
    port = _port(ref, backend=backend, device="cpu")
    rows = _recorded_rows(preset)
    rcache, pcache = RefCache(tmp_path / "ref"), ResultCache(tmp_path / "port")
    rcache.prepare(ref)
    pcache.prepare(port)
    for i, row in enumerate(rows):
        rcache.store_chunk(ref, f"shape-{i:04d}-{row['label']}", study._jsonify(row))
        pcache.store_chunk(port, study.calibrate_chunk_key(i, row, "cpu"), study._jsonify(row))
    want = ref.run(cache=rcache)
    got = port.run(cache=pcache)
    assert got.cache["hits"] == want.cache["hits"] == len(rows)
    assert got.cache["misses"] == 0
    assert _payload(got) == _payload(want)
    assert got.describe() == want.describe()
    assert pcache.study_dir(port).name == rcache.study_dir(ref).name


def test_calibrate_chunks_are_keyed_on_the_device(tmp_path):
    """Timings stored for a card are not replayed on the CPU; the CPU's own
    are, bit for bit."""
    port = _port(ref_study.Study.example("calibrate"), device="cpu")
    cache = ResultCache(tmp_path)
    cache.prepare(port)
    rows = cal.shape_grid(port.analysis.calibrate)
    card = "NVIDIA_H100_80GB_HBM3"
    fake = _recorded_rows("smoke")
    for i, row in enumerate(rows):
        key = study.calibrate_chunk_key(i, row, "cpu")
        assert key == f"shape-{i:04d}-{row['label']}-cpu"
        cache.store_chunk(port, key[: -len("cpu")] + card, study._jsonify(fake[i]))
    first = port.run(cache=ResultCache(tmp_path))
    assert first.cache == {**first.cache, "hits": 0, "misses": len(rows)}
    assert [r["t_s"] for r in _payload(first)["rows"]] != [r["t_s"] for r in fake]
    again = port.run(cache=ResultCache(tmp_path))
    assert again.cache["hits"] == len(rows) and again.cache["misses"] == 0
    assert _payload(again) == _payload(first)
    assert len(ResultCache(tmp_path).chunk_keys(port)) == 2 * len(rows)


def test_backend_and_device_validation(monkeypatch):
    d = ref_study.Study.example("evaluate").to_dict()
    d["analysis"]["backend"] = "jax"  # a spec the reference may write
    with pytest.raises(ValueError, match="'numpy', 'torch'"):
        study.Study.from_dict(d)
    # a spec that names no backend runs on torch (the card); numpy is asked for
    assert study.AnalysisSpec().backend == "torch"
    assert study.AnalysisSpec(device="cpu").device == "cpu"
    with pytest.raises(ValueError, match="numpy backend takes no device"):
        study.AnalysisSpec(backend="numpy", device="cpu")
    with pytest.raises(ValueError, match="invalid device"):
        study.AnalysisSpec(backend="torch", device="tpu")
    assert study.AnalysisSpec(backend="torch", device=torch.device("cpu")).device == "cpu"
    # calibrate measures on its device whatever the backend
    assert study.AnalysisSpec(kind="calibrate", device="cpu").device == "cpu"
    # None is the card, resolved when the study runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    torch_spec = _port(ref_study.Study.example("evaluate"), backend="torch")
    assert torch_spec.analysis.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_spec.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(ref_study.Study.example("calibrate")).run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        study.Study.example("evaluate").run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dse.fig5_study(ks=(255,), tiers=(1, 2)).run()


@pytest.mark.parametrize("kind", ["evaluate", "schedule", "serve", "search"])
def test_resume_reuses_every_chunk(tmp_path, capsys, kind):
    spec = tmp_path / "spec.json"
    _port(ref_study.Study.example(kind), backend="torch").save(spec)
    cold, warm = tmp_path / "cold.json", tmp_path / "warm.json"
    root = tmp_path / "cache"
    assert cli.main(["run", str(spec), "--cache", str(root), "--device", "cpu",
                     "--out", str(cold)]) == 0
    err = capsys.readouterr().err
    assert "0 chunk(s) reused" in err
    n = int(err.split("reused, ")[1].split()[0])
    assert n >= 1
    assert cli.main(["run", "--resume", str(root), "--device", "cpu", "--out", str(warm)]) == 0
    assert f"{n} chunk(s) reused, 0 computed" in capsys.readouterr().err
    a, b = study.StudyResult.load(cold), study.StudyResult.load(warm)
    assert _payload(a) == _payload(b) == _ref_run(kind, False)[0]
    assert a.study.analysis.device == "cpu"


def test_default_cache_dir_is_the_ports_own(tmp_path, monkeypatch, capsys):
    from repro.core.cache import DEFAULT_CACHE_DIR as REF_DIR

    assert DEFAULT_CACHE_DIR == ".repro_torch_cache" != REF_DIR
    spec = tmp_path / "spec.json"
    _port(ref_study.Study.example("advise")).save(spec)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["run", str(spec), "--cache"]) == 0
    capsys.readouterr()
    assert (tmp_path / DEFAULT_CACHE_DIR).is_dir() and not (tmp_path / REF_DIR).exists()


def test_cli_example_spec_templates_run_on_torch(capsys):
    for kind in ref_study.ANALYSIS_KINDS:
        assert cli.main(["example-spec", kind]) == 0
        s = study.Study.from_json(capsys.readouterr().out)
        ref = ref_study.Study.example(kind)
        assert s.analysis.backend == "torch" and s.analysis.device is None
        assert study_hash(s) == ref_hash(ref) and s.name == ref.name
    assert cli.main(["example-spec", "serve", "--transient"]) == 0
    assert study.Study.from_json(capsys.readouterr().out).analysis.thermal == "transient"


def test_cli_device_override_and_bad_specs(tmp_path, capsys, monkeypatch):
    spec = tmp_path / "spec.json"
    _port(ref_study.Study.example("evaluate")).save(spec)  # backend numpy
    with pytest.raises(SystemExit, match="numpy backend takes no device"):
        cli.main(["run", str(spec), "--device", "cpu"])
    monkeypatch.setattr("sys.stdin", io.StringIO('{"workload": {"kind": "gemms", "gemm": []}}'))
    with pytest.raises(SystemExit, match="invalid study spec"):
        cli.main(["run", "-"])
    with pytest.raises(SystemExit, match="does not exist"):
        cli.main(["run", str(tmp_path / "missing.json")])


@pytest.mark.parametrize("command", [["bench"], ["bench", "--which", "dse"]])
def test_cli_report_and_bench_are_not_ported(command, capsys):
    """``bench`` waits for the port's own benchmark; ``report`` is ported
    (tests/test_torch_report.py)."""
    if len(command) == 1:
        with pytest.raises(NotImplementedError, match="the port's own benchmark"):
            cli.main(command)
    else:  # the JAX package's options are not taken
        with pytest.raises(SystemExit) as e:
            cli.main(command)
        assert e.value.code == 2 and "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("kind", ["evaluate", "schedule", "serve"])
def test_cli_pipeline_in_subprocesses(kind):
    """``python -m repro_torch example-spec KIND | python -m repro_torch run -
    --device cpu``, as a user types it."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    ex = subprocess.run([sys.executable, "-m", "repro_torch", "example-spec", kind],
                        capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
                        check=True)
    run = subprocess.run([sys.executable, "-m", "repro_torch", "run", "-", "--device", "cpu"],
                         input=ex.stdout, capture_output=True, text=True, timeout=120,
                         env=env, cwd=REPO)
    assert run.returncode == 0, run.stderr[-2000:]
    art = json.loads(run.stdout)
    assert art["study"]["analysis"]["backend"] == "torch"
    assert art["study"]["analysis"]["device"] == "cpu"
    assert art["payload"] == _ref_run(kind, False)[0]
    assert _ref_run(kind, False)[1] in run.stderr


# ---------------------------------------------------------------------------
# dse: the paper-figure builders and their deprecated shims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fig,kw", [
    ("fig5", {}), ("fig6", {}), ("fig7", {}),
    ("fig5", {"mac_budgets": (2**12, 2**16), "ks": (255, 12100), "tiers": tuple(range(1, 9))}),
    ("fig6", {"ns": (147,), "tiers": 2, "mode": "square"}),
    ("fig7", {"mac_budgets": (2**14,), "n_workloads": 25, "seed": 3, "max_tiers": 8}),
])
@pytest.mark.parametrize("backend", BACKENDS, ids=["numpy", "torch-cpu"])
def test_dse_studies_match_reference(fig, kw, backend):
    got = getattr(dse, f"{fig}_study")(**kw, **backend)
    want = getattr(ref_dse, f"{fig}_study")(**kw)
    assert study_hash(got) == ref_hash(want)
    p = _payload(got.run())
    assert p == _payload(want.run())
    if fig == "fig5" and not kw:
        assert round(p["speedup"][2][3][11], 2) == 9.57  # K 12100, 2^18 MACs, 12 tiers
    if fig == "fig7" and not kw:
        assert p["medians"] == [2.0, 4.0, 7.0]


def test_random_workloads_match_reference():
    for n, seed in ((300, 0), (17, 5)):
        a, b = dse.random_workloads(n, seed), ref_dse.random_workloads(n, seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert dse.PAPER_WORKLOADS == ref_dse.PAPER_WORKLOADS


def test_dse_shims_warn_and_match_reference():
    budgets, ks, tiers = (2**12, 2**16), (255, 12100), tuple(range(1, 9))
    with pytest.warns(DeprecationWarning, match="fig5_study"):
        got = dse.fig5_sweep(budgets, ks, tiers, backend="torch", device="cpu")
    with pytest.warns(DeprecationWarning, match="fig5_study"):
        assert got == ref_dse.fig5_sweep(budgets, ks, tiers)
    with pytest.warns(DeprecationWarning, match="fig6_study"):
        got = dse.fig6_sweep(backend="numpy")
    with pytest.warns(DeprecationWarning, match="fig6_study"):
        assert got == ref_dse.fig6_sweep()
    with pytest.warns(DeprecationWarning, match="fig7_study"):
        got = dse.fig7_scatter((2**14, 2**16), n_workloads=25, max_tiers=8,
                               backend="numpy")
    with pytest.warns(DeprecationWarning, match="fig7_study"):
        want = ref_dse.fig7_scatter((2**14, 2**16), n_workloads=25, max_tiers=8)
    for a, b in zip(got, want):
        assert a.mac_budget == b.mac_budget and a.median == b.median
        assert np.array_equal(a.optimal_tiers, b.optimal_tiers)


# ---------------------------------------------------------------------------
# advisor
# ---------------------------------------------------------------------------

def test_advisor_matches_reference():
    wl = [(64, 1 << 20, 64), (35, 2560, 4096), (4, 576, 49152)]
    with pytest.warns(DeprecationWarning, match="advise"):
        names, totals = advisor.rank_candidates(wl, 16, mac_budget=2**18, thermal_limit=47.0)
    with pytest.warns(DeprecationWarning, match="advise"):
        rn, rt = ref_advisor.rank_candidates(wl, 16, mac_budget=2**18, thermal_limit=47.0)
    assert np.array_equal(names, rn) and np.array_equal(totals, rt)
    # per-workload axis sizes rank directly
    with pytest.warns(DeprecationWarning):
        got = advisor.rank_candidates(wl, [4, 8, 16])
    with pytest.warns(DeprecationWarning):
        want = ref_advisor.rank_candidates(wl, [4, 8, 16])
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for M, K, N in wl:
        g, rg = advisor.GemmShard(M=M, K=K, N=N, axis=8), ref_advisor.GemmShard(M=M, K=K, N=N,
                                                                                axis=8)
        assert [dataclasses.astuple(s) for s in advisor.score_strategies(g)] == \
            [dataclasses.astuple(s) for s in ref_advisor.score_strategies(rg)]
        assert advisor.choose_sharding(g).name == ref_advisor.choose_sharding(rg).name
        assert advisor.advise_layer(M, K, N, 4) == ref_advisor.advise_layer(M, K, N, 4)
    for tokens in (4, 4096):
        got = advisor.choose_block_strategy(tokens, 2048, 8192, 16, 128, 8)
        want = ref_advisor.choose_block_strategy(tokens, 2048, 8192, 16, 128, 8)
        assert repr(got) == repr(want)
