"""The port's guided Pareto search against the JAX package's, on the CPU.

``core.search`` is a numpy copy of the reference's; the torch backend
enters only through ``engine.evaluate``. So, exactly: the spec's
validation, the axes, every candidate batch's objectives, the exhaustive
frontier, the hypervolume, and the whole payload of a search at
``backend="numpy"`` and at ``backend="torch", device="cpu"``. The port
spawns its worker processes (a forked child cannot use CUDA once the
parent has), so the worker-count invariance is held through spawned
workers, in a subprocess with a time limit: payloads at ``workers`` 1
and 2 are bit-identical, and equal to the reference's.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.core import search as ref_search
from repro.core import study as ref_study
from repro_torch.core import search, study
from repro_torch.core.cache import ResultCache
from repro_torch.parallel import work_queue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = [{"backend": "numpy"}, {"backend": "torch", "device": "cpu"}]


def _ref_study(budgets=(2**10, 2**12), tiers=(1, 2, 4), dataflow=("dos", "ws"),
               tech=("tsv", "miv"), generations=2, population=16, refine=(2, 1),
               seed=0, **search_kw):
    return ref_study.Study(
        name="search-test",
        workload=ref_study.WorkloadSpec(kind="gemms", gemms=((64, 8, 64), (128, 16, 96))),
        space=ref_study.SpaceSpec(mac_budgets=budgets, tiers=tiers, dataflow=dataflow,
                                  tech=tech),
        analysis=ref_study.AnalysisSpec(
            kind="search",
            bandwidth=ref_study.BandwidthSpec.paper_default(),
            search=ref_search.SearchSpec(objectives=("cycles", "energy_j"),
                                         generations=generations, population=population,
                                         refine=refine, seed=seed, **search_kw),
        ),
    )


def _port(ref, **analysis):
    d = ref.to_dict()
    d["analysis"].update(analysis)
    return study.Study.from_dict(d)


def _payload(result) -> dict:
    return result.to_dict()["payload"]


STUDIES = {
    "full-coverage": {},
    "partial": dict(budgets=(2**10, 2**12, 2**14, 2**16), generations=3, population=8,
                    refine=(2, 1, 1)),
    "seed-7": dict(budgets=tuple(2**k for k in range(8, 17)), tiers=tuple(range(1, 9)),
                   generations=4, population=24, refine=(4, 2, 1), seed=7),
    "memory-axes": dict(generations=3, population=20, refine=(2, 1),
                        dram_gbs=(64.0, 256.0), sram_kib=(256.0, 1024.0)),
    "folds": dict(generations=2, population=12, folds=("m", "k", "n"),
                  ref_point=(1e7, 1e-2)),
    "no-evolution": dict(budgets=tuple(2**k for k in range(8, 17)), generations=3,
                         population=10, mutation=0.0, crossover=0.0, seed=2),
}


@pytest.mark.parametrize("kw", BACKENDS, ids=["numpy", "torch-cpu"])
@pytest.mark.parametrize("name", list(STUDIES))
def test_search_matches_reference(name, kw):
    ref = _ref_study(**STUDIES[name])
    got = _port(ref, **kw).run()
    want = ref.run()
    assert _payload(got) == _payload(want)
    assert got.describe() == want.describe()


@pytest.mark.parametrize("name", ["full-coverage", "memory-axes", "folds"])
def test_exhaustive_frontier_and_candidates_match_reference(name):
    ref = _ref_study(**STUDIES[name])
    port = _port(ref, backend="torch", device="cpu")
    got, want = search.exhaustive_frontier(port, block=7), ref_search.exhaustive_frontier(ref)
    assert got["space_size"] == want["space_size"] and got["n_feasible"] == want["n_feasible"]
    for k in ("frontier_candidates", "frontier_objectives"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    axes = search.resolve_axes(port)
    assert [(a.name, a.values.tolist()) for a in axes] == \
        [(a.name, a.values.tolist()) for a in ref_search.resolve_axes(ref)]
    rng = np.random.default_rng(0)
    cands = np.stack([rng.integers(0, a.values.shape[0], 40) for a in axes], axis=1)
    for a, b in zip(search.evaluate_candidates(port, cands),
                    ref_search.evaluate_candidates(ref, cands)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("d,n", [(1, 5), (2, 30), (3, 25), (4, 12)])
def test_hypervolume_matches_reference(d, n):
    rng = np.random.default_rng(d * 100 + n)
    pts = rng.uniform(0.0, 1.0, (n, d))
    pts[0, 0] = np.inf  # never contributes
    for ref_point in (np.ones(d), np.full(d, 0.7)):
        assert search.hypervolume(pts, ref_point) == ref_search.hypervolume(pts, ref_point)


@pytest.mark.parametrize("bad", [
    dict(objectives=("cyclesss",)), dict(generations=0), dict(population=0),
    dict(refine=(4, 0)), dict(mutation=0.8, crossover=0.4),
    dict(objectives=("cycles", "energy_j"), ref_point=(1.0,)), dict(dram_gbs=(0.0,)),
    dict(folds=("x",)), dict(seed=-1),
])
def test_searchspec_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        ref_search.SearchSpec(**bad)
    with pytest.raises(ValueError) as got:
        search.SearchSpec(**bad)
    assert str(got.value) == str(want.value)


def test_search_resume_and_blocks(tmp_path):
    port = _port(_ref_study(), backend="torch", device="cpu")
    plain = _payload(port.run())
    cold = port.run(cache=ResultCache(tmp_path / "a", block_cells=8))
    assert cold.cache["hits"] == 0 and cold.cache["misses"] > 2
    assert _payload(cold) == plain
    warm = port.run(cache=ResultCache(tmp_path / "a", block_cells=8))
    assert warm.cache["misses"] == 0 and warm.cache["hits"] == cold.cache["misses"]
    assert _payload(warm) == plain


def test_search_workers_bit_identical_through_spawned_workers(tmp_path):
    """``workers`` 1 and 2 (two blocks per generation, so both workers
    price blocks) give the reference's payload; the pool is spawned."""
    ref = _ref_study()
    spec = tmp_path / "spec.json"
    _port(ref, backend="torch", device="cpu").save(spec)
    code = textwrap.dedent(f"""
        import dataclasses, json, sys
        import multiprocessing.context as ctx
        from repro_torch.core.cache import ResultCache
        from repro_torch.core.study import Study

        started = []
        original = ctx.SpawnProcess._Popen
        ctx.SpawnProcess._Popen = staticmethod(lambda p: started.append(1) or original(p))
        s = Study.load({str(spec)!r})
        out = []
        for w in (1, 2):
            s = dataclasses.replace(s, analysis=dataclasses.replace(s.analysis, workers=w))
            r = s.run(cache=ResultCache({str(tmp_path)!r} + f"/w{{w}}", block_cells=8))
            out.append(r.to_dict()["payload"])
        print(json.dumps({{"payloads": out, "spawned": len(started)}}))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=240, cwd=REPO,
                       env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.splitlines()[-1])
    one, two = res["payloads"]
    assert one == two == _payload(ref.run())
    assert res["spawned"] == 2  # one pool of two, for both generations


def test_search_cli_run_with_workers(tmp_path):
    spec = tmp_path / "spec.json"
    _port(_ref_study(), backend="torch").save(spec)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", str(spec), "--workers", "2",
         "--device", "cpu", "--cache", str(tmp_path / "cache")],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    payload = json.loads(out.stdout)["payload"]
    assert payload["n_evaluated"] == 24
    assert payload == _payload(_ref_study().run())


def test_worker_pool_starts_no_worker_without_jobs(tmp_path):
    pool = work_queue.WorkerPool(2)
    assert pool.run("{}", str(tmp_path), 8, []) == [] and pool._ex is None
    pool.close()
