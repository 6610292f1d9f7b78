"""The port's serving-traffic simulator (``core.serve``, a numpy copy)
against the JAX package's, on the CPU, with no tolerance.

The seeded request trace, the specs' validation and the whole
``kind='serve'`` payload — every design point's derived array, queue
metrics and summary — across archs of each family (the simulator lowers
any zoo arch: no model is built), both batching policies, every length
distribution, both step mappings, the transient DVFS governor and
chunked (cached) execution, at ``backend="numpy"`` and at
``backend="torch", device="cpu"``.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import serve as ref_serve
from repro.core import study as ref_study
from repro_torch.core import serve, study
from repro_torch.core.cache import ResultCache

BACKENDS = [{"backend": "numpy"}, {"backend": "torch", "device": "cpu"}]

TRAFFIC = dict(arrival_rps=2048.0, n_requests=8, prompt_mean=64, prompt_max=256,
               output_mean=8, output_max=32, max_batch=4, chunk_prefill=32, seed=0)

CASES = {
    "smollm": ("smollm-135m", {}, {}, "steady"),
    "static-unchunked": ("qwen2.5-3b", dict(policy="static", chunk_prefill=0,
                                            prompt_dist="uniform"), {}, "steady"),
    "moe-fixed-lengths": ("deepseek-moe-16b", dict(prompt_dist="fixed", output_dist="fixed",
                                                   seed=3), {}, "steady"),
    "hybrid-tier-fold": ("zamba2-2.7b", dict(n_requests=6), dict(mapping="tier_fold"),
                         "steady"),
    "ssm-transient": ("xlstm-125m", dict(seed=1), dict(design_tokens=16), "transient"),
    "encdec": ("whisper-medium", dict(n_requests=5, max_batch=2), {}, "steady"),
}


def _ref_serve_study(arch, traffic, serve_kw, thermal):
    return ref_study.Study(
        name="serve-test",
        workload=ref_study.WorkloadSpec(kind="network", arch=arch, shape="decode_32k"),
        space=ref_study.SpaceSpec(mac_budgets=(2**14, 2**16), tiers=(1, 4)),
        analysis=ref_study.AnalysisSpec(
            kind="serve", thermal=thermal,
            bandwidth=ref_study.BandwidthSpec.paper_default(),
            serve=ref_serve.ServeSpec(traffic=ref_serve.TrafficSpec(**{**TRAFFIC, **traffic}),
                                      **serve_kw),
        ),
    )


def _port(ref, **analysis):
    d = ref.to_dict()
    d["analysis"].update(analysis)
    return study.Study.from_dict(d)


def _payload(result) -> dict:
    return result.to_dict()["payload"]


@pytest.mark.parametrize("kw", BACKENDS, ids=["numpy", "torch-cpu"])
@pytest.mark.parametrize("case", list(CASES))
def test_serve_matches_reference(case, kw):
    ref = _ref_serve_study(*CASES[case])
    got = _port(ref, **kw).run()
    want = ref.run()
    assert _payload(got) == _payload(want)
    assert got.describe() == want.describe()


def test_serve_chunked_and_resumed_match_reference(tmp_path):
    ref = _ref_serve_study(*CASES["smollm"])
    port = _port(ref, backend="torch", device="cpu")
    want = _payload(ref.run())
    cold = port.run(cache=ResultCache(tmp_path, block_cells=8))  # one point per block
    assert cold.cache["misses"] == 4 and _payload(cold) == want
    warm = port.run(cache=ResultCache(tmp_path, block_cells=8))
    assert warm.cache == {**warm.cache, "hits": 4, "misses": 0}
    assert _payload(warm) == want


@pytest.mark.parametrize("dist", ["fixed", "uniform", "lognormal"])
@pytest.mark.parametrize("seed", [0, 11])
def test_sample_trace_matches_reference(dist, seed):
    kw = dict(TRAFFIC, n_requests=50, prompt_dist=dist, output_dist=dist, seed=seed)
    got = serve.sample_trace(serve.TrafficSpec(**kw))
    want = ref_serve.sample_trace(ref_serve.TrafficSpec(**kw))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


@pytest.mark.parametrize("bad", [
    dict(policy="greedy"), dict(prompt_dist="zipf"), dict(arrival_rps=0.0),
    dict(n_requests=0), dict(prompt_mean=600, prompt_max=512), dict(chunk_prefill=-1),
])
def test_traffic_spec_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        ref_serve.TrafficSpec(**bad)
    with pytest.raises(ValueError) as got:
        serve.TrafficSpec(**bad)
    assert str(got.value) == str(want.value)


def test_serve_spec_round_trip_and_guards():
    spec = serve.ServeSpec(traffic=dict(TRAFFIC), design_tokens=12, mapping="tier_fold")
    assert serve.ServeSpec.from_dict(spec.to_dict()) == spec
    assert spec.to_dict() == ref_serve.ServeSpec(traffic=dict(TRAFFIC), design_tokens=12,
                                                 mapping="tier_fold").to_dict()
    with pytest.raises(ValueError, match="mapping"):
        serve.ServeSpec(mapping="best")
    gemms = study.Study(workload=study.WorkloadSpec(kind="gemms", gemms=((8, 8, 8),)),
                        analysis=study.AnalysisSpec(kind="serve"))
    with pytest.raises(ValueError, match="kind='network'"):
        gemms.run()
    assert dataclasses.asdict(study.AnalysisSpec(kind="serve").serve) == \
        dataclasses.asdict(ref_study.AnalysisSpec(kind="serve").serve)
