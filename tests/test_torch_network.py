"""The port's arch registry, network lowering and traffic model against
the JAX package's, on the CPU, with no tolerance.

- ``configs``: all ten archs, ``SHAPES``, ``cells()`` and Table I equal
  the reference's field by field.
- ``core.network``: ``lower_network`` on every live cell of ``cells()``
  at full size (a numpy lowering of data: no model is built) gives the
  reference's stream — every named GEMM, count, shape and derived
  quantity; ``lower_zoo`` with and without filters.
- ``analysis.traffic``: the KV-cache, state and per-device HBM traffic
  of every live cell equal the reference's.
"""

import dataclasses

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.analysis import traffic as ref_traffic
from repro.configs import paper_workloads as ref_paper
from repro.core import network as ref_network
from repro_torch import configs
from repro_torch.analysis import traffic
from repro_torch.configs import paper_workloads
from repro_torch.core import network

LIVE, SKIPPED = ref_configs.cells()


def test_registry_and_shapes_match_reference():
    assert list(configs.REGISTRY) == list(ref_configs.REGISTRY)
    assert len(configs.REGISTRY) == 10
    for name, cfg in configs.REGISTRY.items():
        ref = ref_configs.get_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), name
        assert configs.get_config(name) is cfg
        for prop in ("head_dim_", "is_subquadratic", "n_params", "n_active_params"):
            assert getattr(cfg, prop) == getattr(ref, prop), (name, prop)
        assert dataclasses.asdict(configs.reduced(cfg)) == \
            dataclasses.asdict(ref_configs.reduced(ref))
    assert list(configs.SHAPES) == list(ref_configs.SHAPES)
    for name, shape in configs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(ref_configs.SHAPES[name])
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


def test_cells_match_reference():
    live, skipped = configs.cells()
    assert (live, skipped) == (LIVE, SKIPPED)
    assert len(live) == 33 and len(skipped) == 7


def test_paper_workloads_match_reference():
    assert [dataclasses.astuple(g) for g in paper_workloads.WORKLOADS] == \
        [dataclasses.astuple(g) for g in ref_paper.WORKLOADS]


def _stream_fields(s):
    return {
        "arch": s.arch, "shape": s.shape, "mode": s.mode,
        "gemms": [dataclasses.astuple(g) for g in s.gemms],
        "layer_names": s.layer_names, "total_macs": s.total_macs,
        "n_gemm_invocations": s.n_gemm_invocations,
        "compulsory_bytes": (s.compulsory_bytes(), s.compulsory_bytes(2, 4)),
        "arithmetic_intensity": s.arithmetic_intensity(),
    }


@pytest.mark.parametrize("arch,shape", LIVE)
def test_lower_network_matches_reference_on_every_live_cell(arch, shape):
    got = network.lower_network(configs.REGISTRY[arch], configs.SHAPES[shape])
    want = ref_network.lower_network(ref_configs.REGISTRY[arch], ref_configs.SHAPES[shape])
    assert _stream_fields(got) == _stream_fields(want)
    for a, b in ((got.workloads, want.workloads), (got.counts, want.counts)):
        assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b)
    assert [g.total_macs for g in got.gemms] == [g.total_macs for g in want.gemms]


@pytest.mark.parametrize("kw", [{}, {"shapes": ("decode_32k",)},
                                {"archs": ("zamba2-2.7b", "xlstm-125m"), "shapes": ("long_500k",)}])
def test_lower_zoo_matches_reference(kw):
    got, want = network.lower_zoo(**kw), ref_network.lower_zoo(**kw)
    assert [_stream_fields(s) for s in got] == [_stream_fields(s) for s in want]
    assert len(got) == {0: 33, 1: 10, 2: 2}[len(kw)]


@pytest.mark.parametrize("arch", list(ref_configs.REGISTRY))
def test_traffic_model_matches_reference(arch):
    cfg, ref = configs.REGISTRY[arch], ref_configs.REGISTRY[arch]
    assert traffic.attn_ssm_layer_split(cfg) == ref_traffic.attn_ssm_layer_split(ref)
    for b in (1, 2, 4):
        assert traffic.kv_bytes_per_context_token(cfg, b) == \
            ref_traffic.kv_bytes_per_context_token(ref, b)
    assert traffic.state_bytes_per_request(cfg) == ref_traffic.state_bytes_per_request(ref)
    n_params = 1_000_000_007
    for shape_name in [s for a, s in LIVE if a == arch]:
        shape, rshape = configs.SHAPES[shape_name], ref_configs.SHAPES[shape_name]
        for kw in ({"n_chips": 16}, {"n_chips": 256, "model_ax": 8, "microbatches": 4}):
            assert traffic.traffic_bytes_per_device(cfg, shape, n_params, **kw) == \
                ref_traffic.traffic_bytes_per_device(ref, rshape, n_params, **kw)
            assert traffic.hbm_seconds_per_device(cfg, shape, n_params, **kw) == \
                ref_traffic.hbm_seconds_per_device(ref, rshape, n_params, **kw)
