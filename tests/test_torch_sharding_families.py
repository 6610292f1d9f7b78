"""Every family of the zoo sharded over the (data, model) mesh on ``gloo``
ranks, on the CPU: reduced deepseek-moe-16b (MoE), llama-3.2-vision-11b
(vlm: one KV head, so its caches are sharded on their sequence),
zamba2-2.7b (hybrid), xlstm-125m (ssm) and whisper-medium (encdec).

Two spawns (``tests/_torch_ranks.py``): 8 ranks (job ``families8``) run
each family's loss and its gathered gradients at (2, 4), (4, 2) and
(1, 8) under dos, megatron and zero (zero with remat), from the
reference's weights (``models/convert.py``), batch 8 x 32 with image
embeddings and encoder frames drawn from a numpy seed; deepseek's routes
of every rank's rows are recorded beside one device's. 4 ranks (job
``families4``) serve each family at (2, 2) and (1, 4) under dos and
megatron, and at (2, 2) under auto and zero (greedy tokens, and each
rank's cache leaves after a prefill and a decode step against
``plan.serve_cache_specs``), train the MoE, hybrid and xLSTM models 2
steps at (2, 2) with ``train_loop`` and the vision and whisper models 2
steps with ``make_train_step``.

Tolerances: the loss within 1e-5 of the reference's single-device loss
and, at (2, 4), of its sharded loss (both from one ``run_multidevice``
subprocess, 8 fake devices, meshes with ``AxisType.Auto`` axes, beside
the 8 ranks), f32 sums in another order; each
gradient leaf within 1e-3 of its max|g| of the port's single-device
gradients; the routes and the greedy tokens those of one rank; the
first training step's loss within 1e-5 of one rank's (the same weights),
the second's within 1e-5 of it relative: AdamW's first update moves a
weight by up to lr wherever its gradient is as small as the f32 noise
of the sums' order (zamba2's shared ``wk``: 2.7e-4 apart after one step
at (2, 2), where every gradient leaf agrees within 2e-5 of its max|g|),
and reduced zamba2's second loss moved 1.05e-5 (1.7e-6 of it).
"""

import json
import pickle
import threading

import jax
import numpy as np
import pytest

from _torch_ranks import run_ranks, shared, train_steps
from conftest import run_multidevice
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build as jax_build
from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import serve_loop
from repro_torch.launch.train import train_loop
from repro_torch.optim import OptConfig

FAMILIES = ("deepseek-moe-16b", "llama-3.2-vision-11b", "zamba2-2.7b", "xlstm-125m",
            "whisper-medium")
INPUT = {"llama-3.2-vision-11b": ("image_embeds", "n_image_tokens"),
         "whisper-medium": ("enc_frames", "enc_seq")}
MESHES8 = [(2, 4), (4, 2), (1, 8)]
STRATEGIES = ("dos", "megatron", "zero")
BATCH, SEQ = 8, 32
SERVE_RUNS = [(2, 2, "dos"), (2, 2, "megatron"), (1, 4, "dos"), (1, 4, "megatron"),
              (2, 2, "auto"), (2, 2, "zero")]
SERVE = {"batch": 4, "prompt": 8, "gen": 4}
OPT = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 4}
TRAIN_LOOP = ("deepseek-moe-16b", "zamba2-2.7b", "xlstm-125m")
TRAIN_STEP = ("llama-3.2-vision-11b", "whisper-medium")
TRAIN = {"steps": 2, "batch": 4, "seq": 16}

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
    out[f"{arch} single"] = float(jax.jit(model.loss)(params, batch))
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    for strategy in STRATEGIES:
        rules = ShardingRules(mesh, strategy=strategy, fsdp=True)
        with use_rules(rules), mesh:
            p = jax.device_put(params, param_sharding(model.defs, rules))
            out[f"{arch} {strategy}"] = float(jax.jit(model.loss)(p, batch))
print("LOSSES " + json.dumps(out))
"""


def _cfg(arch):
    return reduced(get_config(arch))


def _extra(arch, cfg, batch, seed):
    """The family's input beside the tokens (numpy, f32), or none."""
    if arch not in INPUT:
        return {}
    name, length = INPUT[arch]
    x = np.random.default_rng(seed).standard_normal((batch, getattr(cfg, length), cfg.d_model))
    return {name: x.astype(np.float32)}


def _train_batches(arch, cfg):
    rng = np.random.default_rng(5)
    out = []
    for i in range(TRAIN["steps"]):
        toks = rng.integers(0, cfg.vocab, (TRAIN["batch"], TRAIN["seq"]))
        out.append({"tokens": toks, "labels": np.roll(toks, -1, 1),
                    **_extra(arch, cfg, TRAIN["batch"], 6 + i)})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared(tmp_path_factory, "sharding_families", _runs)


def _runs(work):
    loss_cases = []
    for arch in FAMILIES:
        model = jax_build(jax_reduced(jax_get_config(arch)))
        params = model.init(jax.random.PRNGKey(0))
        toks = np.random.default_rng(1).integers(0, model.cfg.vocab, (BATCH, SEQ))
        batch = {"tokens": toks.astype(np.int32), "labels": np.roll(toks, -1, 1).astype(np.int32),
                 **_extra(arch, model.cfg, BATCH, 2)}
        np.savez(work / f"{arch}.npz", **batch)
        loss_cases.append({"cfg": (arch, {}), "params": jax.tree.map(np.asarray, params),
                           **{k: v.astype(np.int64) if k in ("tokens", "labels") else v
                              for k, v in batch.items()},
                           "meshes": MESHES8, "strategies": STRATEGIES})
    serve_cases = [{"name": arch, "cfg": (arch, {}), **SERVE, "runs": SERVE_RUNS}
                   for arch in FAMILIES]
    loop_cases = [{"name": arch, "cfg": (arch, {}), **TRAIN, "strategy": "dos", "opt": OPT}
                  for arch in TRAIN_LOOP]
    step_cases = [{"name": arch, "cfg": (arch, {}), "strategy": "megatron", "opt": OPT,
                   "batches": _train_batches(arch, _cfg(arch))} for arch in TRAIN_STEP]
    (work / "inputs.pkl").write_bytes(pickle.dumps(
        {"families_loss": loss_cases, "families_serve": serve_cases,
         "families_train_loop": loop_cases, "families_train_step": step_cases}))

    code = (_JAX_SHARDED.replace("ARCHS", repr(list(FAMILIES)))
            .replace("STRATEGIES", repr(STRATEGIES)).replace("WORKDIR", str(work)))
    jax_out = {}
    th = threading.Thread(target=lambda: jax_out.update(out=run_multidevice(code)))
    th.start()
    try:
        families8 = run_ranks("families8", 8, work, timeout=600)
        families4 = run_ranks("families4", 4, work, timeout=600)
    finally:
        th.join()
    line = next(ln for ln in jax_out["out"].splitlines() if ln.startswith("LOSSES "))
    jax_losses = json.loads(line[len("LOSSES "):])
    one_rank = {
        "serve": {arch: serve_loop(_cfg(arch), batch=SERVE["batch"], prompt_len=SERVE["prompt"],
                                   gen_tokens=SERVE["gen"], device="cpu")["generated"].tolist()
                  for arch in FAMILIES},
        "train": {**{c["name"]: train_loop(_cfg(c["name"]), steps=c["steps"],
                                           global_batch=c["batch"], seq_len=c["seq"],
                                           log_every=0, opt_cfg=OptConfig(**OPT),
                                           device="cpu")[1] for c in loop_cases},
                  **{c["name"]: train_steps(_cfg(c["name"]), c) for c in step_cases}},
    }
    return {"families8": families8, "families4": families4,
            "jax_single": {arch: jax_losses[f"{arch} single"] for arch in FAMILIES},
            "jax_sharded": jax_losses, "one_rank": one_rank}


LOSS_CASES = [(a, mesh, s) for a in FAMILIES for mesh in MESHES8 for s in STRATEGIES]


def _loss_run(runs, arch, mesh, strategy):
    return runs["families8"][f"{arch}-smoke {tuple(mesh)} {strategy}"]


@pytest.mark.parametrize("arch,mesh,strategy", LOSS_CASES)
def test_family_loss_matches_the_reference(runs, arch, mesh, strategy):
    got = _loss_run(runs, arch, mesh, strategy)["loss"]
    assert abs(got - runs["jax_single"][arch]) < 1e-5, (got, runs["jax_single"][arch])
    if tuple(mesh) == (2, 4):
        want = runs["jax_sharded"][f"{arch} {strategy}"]
        assert abs(got - want) < 1e-5, (got, want)


@pytest.mark.parametrize("arch,mesh,strategy", LOSS_CASES)
def test_family_gradients_match_one_device(runs, arch, mesh, strategy):
    gap = _loss_run(runs, arch, mesh, strategy)["grad_gap"]
    assert gap < 1e-3, gap


@pytest.mark.parametrize("mesh,strategy", [(m, s) for m in MESHES8 for s in STRATEGIES])
def test_moe_routes_equal_one_device(runs, mesh, strategy):
    """Every rank's rows, at every layer of the forward, take the experts
    one device gives them."""
    assert _loss_run(runs, "deepseek-moe-16b", mesh, strategy)["routes_differ"] == 0


SERVE_CASES = [(a, (d, m), s) for a in FAMILIES for d, m, s in SERVE_RUNS]


@pytest.mark.parametrize("arch,mesh,strategy", SERVE_CASES)
def test_family_served_tokens_equal_one_rank(runs, arch, mesh, strategy):
    got = runs["families4"]["serve"][f"{arch} {mesh} {strategy}"]
    assert got == runs["one_rank"]["serve"][arch]


@pytest.mark.parametrize("arch,mesh,strategy", SERVE_CASES)
def test_family_cache_holds_its_placement(runs, arch, mesh, strategy):
    """After a prefill and after a decode step each rank's cache leaves
    (the xLSTM's states, the Mamba2 states, the cross k and v included)
    have the shapes of their shards under ``plan.serve_cache_specs``."""
    assert runs["families4"]["cache"][f"{arch} {mesh} {strategy}"] == []


@pytest.mark.parametrize("arch", TRAIN_LOOP + TRAIN_STEP)
def test_family_training_at_2x2_matches_one_rank(runs, arch):
    """``train_loop`` (MoE, hybrid, xLSTM) or ``make_train_step`` (vision,
    whisper: the batch holds their image embeddings or frames)."""
    got = runs["families4"]["train"][arch]
    want = runs["one_rank"]["train"][arch]
    assert len(got) == TRAIN["steps"] and abs(got[0] - want[0]) < 1e-5, (got, want)
    assert np.allclose(got[1:], want[1:], rtol=1e-5, atol=0), (got, want)
