"""The port's placement tables against the reference's, exactly; the
mesh, the collectives at one rank, and the device-sharded search.

The reference's ``ShardingRules``, ``param_sharding``, ``cache_shardings``,
``batch_sharding``, ``make_plan`` and ``act_spec`` evaluate on a
``jax.sharding.AbstractMesh`` with no devices, and the port's on a
``MeshSpec``, so the tables of a 16 x 16 and a 2 x 16 x 16 mesh are
compared in one process. Specs are compared as tuples of axis names per
dim (``"data"`` and ``("data",)`` alike, as ``PartitionSpec`` prints
both), with no tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.config import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.analytical import _search_rc
from repro.models import build as jax_build
from repro.parallel import axes as jax_axes
from repro.parallel.axes import ShardingRules as JaxRules
from repro.parallel.axes import param_sharding as jax_param_sharding
from repro.parallel.plan import batch_sharding as jax_batch_sharding
from repro.parallel.plan import cache_shardings as jax_cache_shardings
from repro.parallel.plan import make_plan as jax_make_plan
from repro_torch.config import SHAPES
from repro_torch.configs import REGISTRY, get_config, reduced
from repro_torch.core.analytical import _search_rc_torch
from repro_torch.core.engine import DesignGrid, evaluate
from repro_torch.launch.mesh import MeshSpec, make_production_mesh, make_test_mesh
from repro_torch.models import build
from repro_torch.models.params import leaves
from repro_torch.parallel import collectives as C
from repro_torch.parallel.axes import ShardingRules, param_sharding, shard, spec_axes, use_rules
from repro_torch.parallel.plan import (
    _input_specs, abstract_cache, batch_sharding, cache_shardings, gather_tree, make_plan,
    serve_cache_specs, shard_tree,
)
from repro_torch.parallel.shard_eval import resolve_shards, sharded_search

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "8x1": ((8, 1), ("data", "model")),
    "1x8": ((1, 8), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
STRATEGIES = ("dos", "megatron", "zero", "auto")


def _norm(spec) -> tuple:
    return tuple(spec_axes(p) for p in spec)


def _jax_tree(tree) -> dict:
    """{path: normalised spec} of a tree of NamedShardings."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): _norm(s.spec)
            for path, s in flat}


def _port_tree(tree) -> dict:
    return {path: _norm(s) for path, s in leaves(tree)}


def _rules(mesh_key, strategy, fsdp):
    sizes, names = MESHES[mesh_key]
    return (JaxRules(AbstractMesh(sizes, names), strategy=strategy, fsdp=fsdp),
            ShardingRules(MeshSpec(sizes, names), strategy=strategy, fsdp=fsdp))


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", list(REGISTRY))
def test_param_sharding_equals_the_reference(arch, mesh_key):
    for size in ("full", "reduced"):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        if size == "reduced":
            jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
        jdefs, defs = jax_build(jcfg).defs, build(cfg, device="cpu").defs
        for strategy in STRATEGIES:
            for fsdp in (True, False):
                jr, r = _rules(mesh_key, strategy, fsdp)
                want = _jax_tree(jax_param_sharding(jdefs, jr))
                got = _port_tree(param_sharding(defs, r))
                assert got == want, (arch, size, mesh_key, strategy, fsdp)


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", list(REGISTRY))
def test_cache_and_batch_shardings_equal_the_reference(arch, mesh_key):
    """Every k/v and state leaf of the cache (the reference's per-layer
    ``length`` has no counterpart: the port keeps one), at the reference's
    serving shapes and a small one; every input at every shape. Where the
    reference's table maps a mesh axis twice (``zero`` with ``model``),
    both raise."""
    jmodel, cfg = jax_build(jax_get_config(arch)), get_config(arch)
    for strategy in STRATEGIES:
        jr, r = _rules(mesh_key, strategy, True)
        for name, jshape in JAX_SHAPES.items():
            shape = SHAPES[name]
            want = _jax_tree(jax_batch_sharding(jr, jmodel.input_specs(jshape)))
            assert _port_tree(batch_sharding(r, _input_specs(cfg, shape))) == want
            if shape.mode == "train":
                continue
            b, s = shape.global_batch, shape.seq_len
            ac = jmodel.abstract_cache(b, s, jnp.bfloat16)
            try:
                want = _jax_tree(jax_cache_shardings(jr, ac, b))
            except Exception as e:  # DuplicateSpecError
                assert "duplicate" in str(e).lower()
                with pytest.raises(ValueError, match="to two dims"):
                    cache_shardings(r, abstract_cache(cfg, b, s), b)
                continue
            got = _port_tree(cache_shardings(r, abstract_cache(cfg, b, s), b))
            have = {p: v for p, v in got.items() if p[-1] != "length"}
            assert have == {p: v for p, v in want.items() if p[-1] != "length"}, (name, strategy)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh_key", ["2x4", "16x16", "2x16x16"])
def test_make_plan_equals_the_reference(mesh_key, strategy):
    for arch in ("smollm-135m", "gemma3-1b", "qwen2-72b"):
        jmodel, model = jax_build(jax_get_config(arch)), build(get_config(arch), device="cpu")
        jr, r = _rules(mesh_key, strategy, True)
        for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            try:
                want = jax_make_plan(jmodel, JAX_SHAPES[name], jr)
            except Exception as e:
                assert "duplicate" in str(e).lower()
                with pytest.raises(ValueError, match="to two dims"):
                    make_plan(model, SHAPES[name], r)
                continue
            got = make_plan(model, SHAPES[name], r)
            for jt, t in ((want.in_shardings, got.in_shardings),
                          (want.out_shardings, got.out_shardings)):
                j, p = _jax_tree(jt), _port_tree(list(t))
                assert {k: v for k, v in p.items() if k[-1] != "length"} == \
                    {k: v for k, v in j.items() if k[-1] != "length"}, (arch, name)


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_act_spec_and_shard_equal_the_reference(mesh_key, monkeypatch):
    """The activation table, and ``shard``'s divisibility fallbacks (the
    reference's constraint captured instead of applied)."""
    monkeypatch.setattr(jax_axes.jax.lax, "with_sharding_constraint", lambda x, s: s)
    kinds = ("residual", "attn_heads", "mlp_hidden", "logits", "kv_cache", "decode_residual",
             "ssm_state", "decode_q_kvh", "none")
    shapes = [(32, 128, 2048), (1, 1, 576), (4, 4096, 3, 64), (128, 4096, 16, 128),
              (6, 9, 1, 256), (256, 16, 262144)]
    for strategy in STRATEGIES:
        jr, r = _rules(mesh_key, strategy, True)
        for kind in kinds:
            assert _norm(r.act_spec(kind)) == _norm(jr.act_spec(kind)), (strategy, kind)
            for shp in shapes:
                with jax_axes.use_rules(jr):
                    want = jax_axes.shard(jax.ShapeDtypeStruct(shp, jnp.float32), kind)
                with use_rules(r):
                    got = shard(torch.empty(shp, device="meta"), kind)
                assert _norm(got) == _norm(want.spec), (strategy, kind, shp)


def test_serving_under_zero_takes_the_reference_attention_cache_layout():
    """``zero`` serving: the cache table maps ``model`` twice, so serving
    places the cache as the reference's attention constrains it, the batch
    over the whole mesh."""
    r = ShardingRules(MeshSpec((2, 2), ("data", "model")), strategy="zero", fsdp=False)
    cfg = reduced(get_config("smollm-135m"))
    ac = abstract_cache(cfg, 4, 32)
    with pytest.raises(ValueError, match="'model' to two dims"):
        cache_shardings(r, ac, 4)
    assert serve_cache_specs(r, ac, 4)["layers"]["k"] == (None, ("data", "model"), None, None, None)
    with use_rules(r):
        assert shard(ac["layers"]["k"][0], "kv_cache") == (("data", "model"), None, None, None)


# --- the mesh and the collectives at one rank ------------------------------------


def test_meshes():
    assert make_production_mesh() == MeshSpec((16, 16), ("data", "model"))
    assert make_production_mesh(multi_pod=True) == MeshSpec((2, 16, 16), ("pod", "data", "model"))
    assert make_test_mesh() == MeshSpec((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match=r"a \(2, 4\) mesh needs a process group of 8 ranks"):
        make_test_mesh(2, 4)
    with pytest.raises(ValueError, match="strategy 'pipe'"):
        ShardingRules(make_test_mesh(), strategy="pipe")


def test_collectives_at_one_rank_return_their_input_without_a_call():
    # no process group exists: any call into torch.distributed would raise
    mesh = make_test_mesh()
    x = torch.randn(4, 6)
    for fn in (C.all_reduce, C.all_reduce_max, C.copy_to):
        assert fn(x, mesh, ("model",)) is x
    for fn in (C.reduce_scatter, C.all_gather, C.split):
        assert fn(x, mesh, ("data", "model"), -1) is x
    assert C.gather_params(x, mesh, "data", 0) is x
    spec = {"w": ("data", "model")}
    local = shard_tree({"w": x}, spec, mesh)
    assert torch.equal(local["w"], x) and local["w"].data_ptr() != x.data_ptr()
    assert torch.equal(gather_tree(local, spec, mesh)["w"], x)


class _Rank:
    """One rank's view of a mesh, as ``DeviceMesh`` gives it."""

    def __init__(self, sizes, names, coord):
        self.shape, self.mesh_dim_names, self.coord = sizes, names, coord

    def get_coordinate(self):
        return list(self.coord)


def test_shards_of_a_multi_axis_spec_are_the_reference_blocks():
    """``shard_of`` cuts a dim split over several axes with the first
    axis major, as a ``NamedSharding`` lays its shards out."""
    x = torch.arange(64.0 * 3).reshape(8, 8, 3)
    for d in range(2):
        for m in range(4):
            rank = _Rank((2, 4), ("data", "model"), (d, m))
            got = C.shard_of(x, (("data", "model"), None, None), rank)
            assert torch.equal(got, x[d * 4 + m:d * 4 + m + 1])
            got = C.shard_of(x, ("model", "data"), rank)
            assert torch.equal(got, x[2 * m:2 * m + 2, 4 * d:4 * d + 4])


# --- the device-sharded search ---------------------------------------------------


def _search_args(rng, b):
    d1 = rng.integers(1, 3000, b)
    d2 = rng.integers(1, 3000, b)
    tser = rng.integers(1, 5000, b)
    budget = rng.choice([2**12, 2**14, 2**16], b)
    return [np.asarray(a, dtype=np.int64) for a in (d1, d2, tser, budget)]


@pytest.mark.parametrize("b,n_shards", [(3, 8), (1, 4), (29, 8), (48, 3), (14, 5)])
def test_sharded_search_is_bit_identical(b, n_shards):
    """Batches smaller than the shard count, of one row, and ragged: padded
    with all-ones rows, each shard searched on its device (here every
    shard on the CPU), sliced back; bit for bit the unsharded search, and
    the reference's numpy search."""
    args = _search_args(np.random.default_rng(b * 100 + n_shards), b)
    r_max = int(np.minimum(args[0], args[3]).max())
    dev = torch.device("cpu")
    got = sharded_search(*args, r_max, n_shards, devices=[dev] * n_shards)
    want = _search_rc_torch(*(torch.from_numpy(a) for a in args), r_max)
    ref = _search_rc(np, *args, r_max)
    for g, w, rf in zip(got, want, ref):
        assert g.dtype == np.int64 and np.array_equal(g, w.numpy()) and np.array_equal(g, rf)


def test_resolve_shards_counts_the_search_device_type():
    cpu = torch.device("cpu")
    assert resolve_shards(None, cpu) == resolve_shards("none", cpu) == resolve_shards(1, cpu) == 1
    assert resolve_shards("auto", cpu) == 1  # one CPU device
    with pytest.raises(ValueError, match="shard=2 exceeds the 1 local cpu device"):
        resolve_shards(2, cpu)
    for bad in (0, "bogus"):
        with pytest.raises(ValueError, match="shard"):
            resolve_shards(bad, cpu)


def test_engine_shard_on_the_cpu():
    grid = DesignGrid.product([(64, 300, 64), (35, 2560, 4096)], (2**12, 2**16), (1, 2, 3))
    plain = evaluate(grid, backend="torch", device="cpu")
    for shard in ("auto", 1, None):
        got = evaluate(grid, backend="torch", device="cpu", shard=shard)
        for f in dataclasses.fields(got):
            if f.name != "grid" and getattr(got, f.name) is not None:
                assert np.array_equal(getattr(got, f.name), getattr(plain, f.name),
                                      equal_nan=True), f.name
    with pytest.raises(ValueError, match="exceeds the 1 local cpu device"):
        evaluate(grid, backend="torch", device="cpu", shard=2)
    with pytest.raises(ValueError, match="backend='torch'"):
        evaluate(grid, shard=2)
