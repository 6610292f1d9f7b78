"""Expert-parallel MoE of the port (``parallel/moe_ep.py``) on ``gloo``
ranks, on the CPU, against the JAX package's ``moe_block_ep`` and its
replicated ``moe_block``.

Reduced deepseek-moe-16b (8 experts, top-2, one shared expert), the
reference's weights of layer 0's FFN, x (4, 16, 128) and an output
gradient gy drawn with numpy, f32. One spawn (``tests/_torch_ranks.py``
job ``moe_ep``) runs 8 ranks at (2, 4): 2 experts a rank, 2 of the 4
rows a rank. The reference's ``moe_block_ep`` comes from one
``run_multidevice`` call (8 fake devices, the same mesh), its
``moe_block``, top-k indices and ``jax.grad`` of ``sum(moe_block * gy)``
from this process.

Tolerances: the output within 1e-5 of both reference values (f32 sums in
another order), the routing indices equal; the gradients of the router,
the experts (summed over ``data``, gathered over ``model``), the shared
experts and x within 1e-5 of each leaf's max|g|. A wrong gradient
convention (a replicated input not summed over ``model``, or the shared
path summed again) is off by a factor of the axis size. At one rank,
the output and every gradient equal the port's ``moe_block`` bit for bit.
"""

import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks, shared
from conftest import run_multidevice
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build as jax_build
from repro.models.moe import moe_block as jax_moe_block
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import MeshSpec, make_test_mesh
from repro_torch.models.moe import moe_block, moe_defs
from repro_torch.models.params import leaves, map_tree, materialize
from repro_torch.parallel.moe_ep import expert_shard, moe_block_ep

ARCH = "deepseek-moe-16b"
MESH = (2, 4)
X_SHAPE = (4, 16, 128)
TOL = 1e-5

_JAX_EP = """
import numpy as np, jax
from repro.configs import REGISTRY, reduced
from repro.models import build
from repro.parallel.moe_ep import moe_block_ep
cfg = reduced(REGISTRY["ARCH"])
lp = jax.tree.map(lambda a: a[0], build(cfg).init(jax.random.PRNGKey(0))["layers"])["ffn"]
x = np.load("WORKDIR/x.npy")
mesh = jax.make_mesh(MESH, ("data", "model"))
with mesh:
    y = jax.jit(lambda p_, x_: moe_block_ep(p_, x_, cfg, mesh))(lp, x)
np.save("WORKDIR/y_ep.npy", np.asarray(y))
print("MOE_EP_SAVED")
"""


def _reference():
    cfg = jax_reduced(jax_get_config(ARCH))
    lp = jax.tree.map(lambda a: a[0], jax_build(cfg).init(jax.random.PRNGKey(0))["layers"])["ffn"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    gy = rng.standard_normal(X_SHAPE).astype(np.float32)
    y = jax_moe_block(lp, jnp.asarray(x), cfg)
    gp, gx = jax.grad(lambda p, x_: jnp.sum(jax_moe_block(p, x_, cfg) * gy), argnums=(0, 1))(
        lp, jnp.asarray(x))
    logits = jnp.asarray(x).reshape(-1, x.shape[-1]) @ lp["router"]
    top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)[1]
    grads = {**jax.tree.map(np.asarray, gp), "x": np.asarray(gx)}
    return (jax.tree.map(np.asarray, lp), x, gy, np.asarray(y), np.asarray(top_i), grads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared(tmp_path_factory, "moe_ep_ranks", _runs)


def _runs(work):
    lp, x, gy, y, top_i, grads = _reference()
    np.save(work / "x.npy", x)
    (work / "inputs.pkl").write_bytes(pickle.dumps({"moe_ep": {
        "cfg": (ARCH, {}), "mesh": MESH, "params": lp, "x": x, "gy": gy, "top_i": top_i,
        "grads": grads}}))
    code = (_JAX_EP.replace("WORKDIR", str(work)).replace("ARCH", ARCH)
            .replace("MESH", repr(MESH)))
    jax_out = {}
    th = threading.Thread(target=lambda: jax_out.update(out=run_multidevice(code)))
    th.start()
    try:
        ranks = run_ranks("moe_ep", MESH[0] * MESH[1], work)
    finally:
        th.join()
    assert "MOE_EP_SAVED" in jax_out["out"]
    return {**ranks, "y_oracle": y, "y_ep": np.load(work / "y_ep.npy")}


def test_output_matches_the_reference_and_moe_block(runs):
    y = np.asarray(runs["y"], dtype=np.float32)
    assert np.abs(y - runs["y_ep"]).max() < TOL, np.abs(y - runs["y_ep"]).max()
    assert np.abs(y - runs["y_oracle"]).max() < TOL, np.abs(y - runs["y_oracle"]).max()


def test_routing_indices_equal_the_reference(runs):
    assert runs["top_i_equal"]


GRAD_LEAVES = ["router", "wi_gate", "wi_up", "wo", "shared.wi_gate", "shared.wi_up",
               "shared.wo", "x"]


@pytest.mark.parametrize("leaf", GRAD_LEAVES)
def test_gradients_match_jax_grad_of_moe_block(runs, leaf):
    assert set(runs["grad_gaps"]) == set(GRAD_LEAVES)
    assert runs["grad_gaps"][leaf] < TOL, runs["grad_gaps"][leaf]


def _one_rank_inputs():
    cfg = reduced(get_config(ARCH))
    p = materialize(moe_defs(cfg), torch.Generator().manual_seed(0))
    x = torch.randn(X_SHAPE, generator=torch.Generator().manual_seed(1))
    return cfg, p, x


def test_one_rank_is_moe_block_bit_for_bit():
    cfg, p, x = _one_rank_inputs()
    gy = torch.randn(X_SHAPE, generator=torch.Generator().manual_seed(2))
    mesh = make_test_mesh(1, 1)
    outs, grads = [], []
    for fn in (lambda p_, x_: moe_block(p_, x_, cfg),
               lambda p_, x_: moe_block_ep(expert_shard(p_, mesh), x_, cfg, mesh)):
        pp = map_tree(lambda a: a.clone().requires_grad_(), p)
        xx = x.clone().requires_grad_()
        y = fn(pp, xx)
        (y * gy).sum().backward()
        outs.append(y.detach())
        grads.append([xx.grad] + [a.grad for _, a in leaves(pp)])
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_bf16_one_rank_is_moe_block_bit_for_bit():
    cfg, p, x = _one_rank_inputs()
    p = map_tree(lambda a: a.to(torch.bfloat16), p)
    p["router"] = p["router"].float()
    x = x.to(torch.bfloat16)
    mesh = make_test_mesh(1, 1)
    assert torch.equal(moe_block(p, x, cfg), moe_block_ep(expert_shard(p, mesh), x, cfg, mesh))


def test_expert_shard_keeps_the_replicated_leaves():
    cfg, p, _ = _one_rank_inputs()
    mesh = make_test_mesh(1, 1)
    tree = expert_shard(p, mesh)
    assert tree["router"] is p["router"] and tree["shared"] is p["shared"]
    assert all(torch.equal(tree[k], p[k]) for k in ("wi_gate", "wi_up", "wo"))


def test_what_moe_block_ep_refuses():
    cfg, p, x = _one_rank_inputs()
    mesh = make_test_mesh(1, 1)
    half = {**p, **{k: p[k][:4] for k in ("wi_gate", "wi_up", "wo")}}
    with pytest.raises(ValueError, match="p holds 4 experts; a rank of 1 holds 8"):
        moe_block_ep(half, x, cfg, mesh)
    with pytest.raises(ValueError, match="8 experts do not split over 3 ranks"):
        moe_block_ep(p, x, cfg, MeshSpec((1, 3), ("data", "model")))
