"""Sharded serving and training of the port on ``gloo`` ranks, on the CPU.

Two spawns: 8 ranks (``tests/_torch_ranks.py`` job ``mesh8``) run the
loss and its gradients of reduced qwen2.5-3b (batch 8: the batch splits
over every data axis) and gemma3-1b (sliding window, qk-norm; batch 4:
at (8, 1) and under ``zero`` at (2, 4) it does not split, and every data
rank takes the whole batch) at meshes (2, 4), (4, 2), (8, 1) and (1, 8)
under dos, megatron and zero (zero with remat), from the reference's
weights (``models/convert.py``), then ``train_loop`` at (4, 2) saving a
checkpoint after 2 steps; 4 ranks (job ``mesh4``) serve at (2, 2),
(1, 4) and (4, 1) under every strategy (reduced smollm-135m: one KV
head, so at ``model`` > 1 the cache is sharded on its sequence; with 2
KV heads at (2, 2), attention on each rank's heads; at batch 2, which
the data axes do not divide, every rank takes the whole batch and the
cache is sharded on its sequence over ``data``), train 3 steps at (2, 2),
restore the (4, 2) checkpoint onto (2, 2), and serve zamba2 at (1, 4) and
train xlstm at (2, 2) (the other families: tests/test_torch_sharding_families.py).

Tolerances: the loss within 1e-5 of the reference's single-device loss
and of its sharded loss (``run_multidevice``, 8 fake devices, meshes
with ``AxisType.Auto`` axes: jax 0.9 makes ``Explicit`` ones by default,
and the reference's embedding gather raises on those), f32 sums in
another order; the gathered gradients within 1e-3 of each leaf's
max|g| of the port's single-device gradients; greedy tokens and the
training losses equal to one rank's (f32: the losses within 1e-5).
"""

import json
import pickle
import threading

import jax
import numpy as np
import pytest

from _torch_ranks import OTHER_SERVE, OTHER_TRAIN, run_ranks, shared
from conftest import run_multidevice
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build as jax_build
from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import serve_loop
from repro_torch.launch.train import train_loop
from repro_torch.optim import OptConfig

LOSS_CONFIGS = {"qwen2.5-3b": 8, "gemma3-1b": 4}  # arch: batch
MESHES8 = [(2, 4), (4, 2), (8, 1), (1, 8)]
LOSS_STRATEGIES = ("dos", "megatron", "zero")
SERVE = [
    {"name": "smollm-135m", "cfg": ("smollm-135m", {}), "batch": 4, "prompt": 16, "gen": 8,
     "meshes": [(2, 2), (1, 4), (4, 1)], "strategies": ["dos", "megatron", "zero", "auto"]},
    {"name": "smollm-135m kvh2", "cfg": ("smollm-135m", {"n_kv_heads": 2}), "batch": 4,
     "prompt": 16, "gen": 8, "meshes": [(2, 2)], "strategies": ["dos", "megatron"]},
    {"name": "smollm-135m batch 2", "cfg": ("smollm-135m", {}), "batch": 2, "prompt": 16,
     "gen": 8, "meshes": [(4, 1), (2, 2)], "strategies": ["dos", "zero"]},
]
TRAIN = {"cfg": ("smollm-135m", {}), "batch": 8, "seq": 32,
         "strategies": ["dos", "megatron", "zero"],
         "opt": {"lr": 1e-3, "warmup_steps": 2, "total_steps": 4}}

_JAX_SHARDED = """
import json
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config, reduced
from repro.models import build
from repro.parallel.axes import ShardingRules, param_sharding, use_rules
out = {}
for arch in ARCHS:
    model = build(reduced(get_config(arch)))
    params = model.init(jax.random.PRNGKey(0))
    batch = dict(np.load(f"WORKDIR/{arch}.npz"))
    for d, m in MESHES:
        mesh = jax.make_mesh((d, m), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        for strategy in STRATEGIES:
            rules = ShardingRules(mesh, strategy=strategy, fsdp=True)
            with use_rules(rules), mesh:
                p = jax.device_put(params, param_sharding(model.defs, rules))
                out[f"{arch} ({d}, {m}) {strategy}"] = float(jax.jit(model.loss)(p, batch))
print("LOSSES " + json.dumps(out))
"""


def _cfg(spec):
    import dataclasses

    arch, over = spec
    return dataclasses.replace(reduced(get_config(arch)), **over)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared(tmp_path_factory, "sharding_ranks", _runs)


def _runs(work):
    loss_cases, single = [], {}
    for arch, b in LOSS_CONFIGS.items():
        model = jax_build(jax_reduced(jax_get_config(arch)))
        params = model.init(jax.random.PRNGKey(0))
        toks = np.random.default_rng(1).integers(0, model.cfg.vocab, (b, 32)).astype(np.int32)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
        single[arch] = float(jax.jit(model.loss)(params, batch))
        np.savez(work / f"{arch}.npz", **batch)
        loss_cases.append({"cfg": (arch, {}), "params": jax.tree.map(np.asarray, params),
                           "tokens": toks.astype(np.int64), "labels": batch["labels"].astype(
                               np.int64), "meshes": MESHES8, "strategies": LOSS_STRATEGIES})
    (work / "inputs.pkl").write_bytes(pickle.dumps(
        {"loss": loss_cases, "serve": SERVE, "train": TRAIN}))

    code = (_JAX_SHARDED.replace("ARCHS", repr(list(LOSS_CONFIGS)))
            .replace("MESHES", repr(MESHES8)).replace("STRATEGIES", repr(LOSS_STRATEGIES))
            .replace("WORKDIR", str(work)))
    jax_out = {}
    th = threading.Thread(target=lambda: jax_out.update(out=run_multidevice(code)))
    th.start()
    try:
        mesh8 = run_ranks("mesh8", 8, work)
        mesh4 = run_ranks("mesh4", 4, work)
    finally:
        th.join()
    line = next(ln for ln in jax_out["out"].splitlines() if ln.startswith("LOSSES "))
    one_rank = {
        "serve": {c["name"]: serve_loop(_cfg(c["cfg"]), batch=c["batch"], prompt_len=c["prompt"],
                                        gen_tokens=c["gen"], device="cpu")["generated"].tolist()
                  for c in SERVE},
        "train": train_loop(_cfg(TRAIN["cfg"]), steps=4, global_batch=TRAIN["batch"],
                            seq_len=TRAIN["seq"], log_every=0, opt_cfg=OptConfig(**TRAIN["opt"]),
                            device="cpu")[1],
        "families": {
            "zamba2-2.7b": serve_loop(_cfg(("zamba2-2.7b", {})), **OTHER_SERVE,
                                      device="cpu")["generated"].tolist(),
            "xlstm-125m": train_loop(_cfg(("xlstm-125m", {})), **OTHER_TRAIN, device="cpu")[1]},
    }
    return {"mesh8": mesh8, "mesh4": mesh4, "jax_single": single,
            "jax_sharded": json.loads(line[len("LOSSES "):]), "one_rank": one_rank}


LOSS_CASES = [(a, mesh, s) for a in LOSS_CONFIGS for mesh in MESHES8 for s in LOSS_STRATEGIES]


@pytest.mark.parametrize("arch,mesh,strategy", LOSS_CASES)
def test_sharded_loss_matches_the_reference(runs, arch, mesh, strategy):
    key = f"{arch} {tuple(mesh)} {strategy}"
    got = runs["mesh8"]["loss"][f"{arch}-smoke {tuple(mesh)} {strategy}"]["loss"]
    assert abs(got - runs["jax_single"][arch]) < 1e-5, (got, runs["jax_single"][arch])
    assert abs(got - runs["jax_sharded"][key]) < 1e-5, (got, runs["jax_sharded"][key])


@pytest.mark.parametrize("arch,mesh,strategy", LOSS_CASES)
def test_sharded_gradients_match_one_device(runs, arch, mesh, strategy):
    gap = runs["mesh8"]["loss"][f"{arch}-smoke {tuple(mesh)} {strategy}"]["grad_gap"]
    assert gap < 1e-3, gap


SERVE_CASES = [(c["name"], tuple(mesh), s) for c in SERVE for mesh in c["meshes"]
               for s in c["strategies"]]


@pytest.mark.parametrize("name,mesh,strategy", SERVE_CASES)
def test_served_tokens_equal_one_rank(runs, name, mesh, strategy):
    got = runs["mesh4"]["serve"][f"{name} {mesh} {strategy}"]
    assert got == runs["one_rank"]["serve"][name]


@pytest.mark.parametrize("strategy", TRAIN["strategies"])
def test_training_at_2x2_matches_one_rank(runs, strategy):
    got = runs["mesh4"]["train"][strategy]
    assert np.allclose(got, runs["one_rank"]["train"][:3], rtol=0, atol=1e-5), got


def test_checkpoint_from_4x2_continues_on_2x2(runs):
    """The reference's ``test_elastic_checkpoint_restore_across_meshes``:
    saved on (4, 2) after 2 steps, restored onto (2, 2), the next 2 steps'
    losses are those of one rank's uninterrupted run."""
    want = runs["one_rank"]["train"]
    assert np.allclose(runs["mesh8"]["train8"]["losses"], want[:2], rtol=0, atol=1e-5)
    assert np.allclose(runs["mesh4"]["resumed"], want[2:], rtol=0, atol=1e-5)


def test_other_families_run_on_a_mesh(runs):
    """The two calls that raised before the other families were sharded:
    zamba2 served at (1, 4) and xlstm trained at (2, 2) give one rank's
    tokens and losses (the second loss within 1e-5 of itself: AdamW's
    first update amplifies the f32 sums' order)."""
    got, want = runs["mesh4"]["families"], runs["one_rank"]["families"]
    assert got["zamba2-2.7b"] == want["zamba2-2.7b"]
    assert abs(got["xlstm-125m"][0] - want["xlstm-125m"][0]) < 1e-5, got
    assert np.allclose(got["xlstm-125m"][1:], want["xlstm-125m"][1:], rtol=1e-5, atol=0), got
