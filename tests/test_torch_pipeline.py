"""GPipe pipeline stages of the port (``parallel/pipeline.py``) on ``gloo``
ranks, on the CPU, against the JAX package's ``make_gpipe_loss`` and its
single-device ``model.loss``.

Reduced smollm-135m (tied embeddings) cut to 4 layers, batch 8 x 32, 4
microbatches, f32: two spawns (``tests/_torch_ranks.py`` jobs
``pipeline4`` and ``pipeline2``) run 4 stages on 4 ranks and 2 stages on
2 ranks, from the reference's weights. The reference's pipelined losses
come from one ``run_multidevice`` call (4 fake devices; the 2-stage mesh
takes 2 of them), its ``model.loss`` and ``jax.grad(model.loss)`` from
this process.

Tolerances: the loss within 1e-5 of both reference values (f32 sums in
another order), on every rank; each gathered gradient leaf within 1e-3
of its max|g| (the sharded tests' band), the tied embedding's (stage 0's
gather plus the last stage's unembedding, summed over the stages) in
its own assertion; one stage in this process equals the port's
``model.loss`` within 1e-6.
"""

import dataclasses
import json
import pickle
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks, shared
from conftest import run_multidevice
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build as jax_build
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import MeshSpec, make_stage_mesh
from repro_torch.models import build
from repro_torch.models.convert import from_numpy
from repro_torch.models.params import leaves, map_tree
from repro_torch.parallel.pipeline import bubble_fraction, make_gpipe_loss, stage_params

OVER = {"n_layers": 4}
BATCH, SEQ, N_MB = 8, 32, 4
STAGES = (4, 2)

_JAX_PIPELINE = """
import json
import dataclasses, jax, numpy as np
from repro.configs import get_config, reduced
from repro.models import build
from repro.parallel.pipeline import make_gpipe_loss
cfg = dataclasses.replace(reduced(get_config("smollm-135m")), n_layers=4)
params = build(cfg).init(jax.random.PRNGKey(0))
batch = dict(np.load("WORKDIR/batch.npz"))
out = {}
for n in STAGES:
    mesh = jax.make_mesh((n,), ("pod",), devices=jax.devices()[:n])
    loss_fn = make_gpipe_loss(cfg, mesh, n_stages=n, n_microbatches=N_MB)
    with mesh:
        out[n] = float(jax.jit(loss_fn)(params, batch))
print("LOSSES " + json.dumps(out))
"""


def _cfg():
    return dataclasses.replace(reduced(get_config("smollm-135m")), **OVER)


def _reference():
    model = jax_build(dataclasses.replace(jax_reduced(jax_get_config("smollm-135m")), **OVER))
    params = model.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, batch)
    return params, batch, float(loss), grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared(tmp_path_factory, "pipeline_ranks", _runs)


def _runs(work):
    params, batch, loss, grads = _reference()
    np.savez(work / "batch.npz", **batch)
    (work / "inputs.pkl").write_bytes(pickle.dumps({"pipeline": {
        "cfg": ("smollm-135m", OVER), "params": jax.tree.map(np.asarray, params),
        "grads": jax.tree.map(np.asarray, grads), "n_mb": N_MB,
        "tokens": batch["tokens"].astype(np.int64), "labels": batch["labels"].astype(np.int64)}}))
    code = (_JAX_PIPELINE.replace("WORKDIR", str(work)).replace("STAGES", repr(STAGES))
            .replace("N_MB", str(N_MB)))
    jax_out = {}
    th = threading.Thread(target=lambda: jax_out.update(out=run_multidevice(code, n_devices=4)))
    th.start()
    try:
        ranks = {n: run_ranks(f"pipeline{n}", n, work) for n in STAGES}
    finally:
        th.join()
    line = next(ln for ln in jax_out["out"].splitlines() if ln.startswith("LOSSES "))
    pipelined = {int(n): v for n, v in json.loads(line[len("LOSSES "):]).items()}
    return {"ranks": ranks, "jax_loss": loss, "jax_pipeline": pipelined}


@pytest.mark.parametrize("n_stages", STAGES)
def test_loss_matches_the_reference_on_every_rank(runs, n_stages):
    losses = runs["ranks"][n_stages]["losses"]
    assert len(losses) == n_stages and len(set(losses)) == 1, losses
    assert abs(losses[0] - runs["jax_pipeline"][n_stages]) < 1e-5, (losses, runs["jax_pipeline"])
    assert abs(losses[0] - runs["jax_loss"]) < 1e-5, (losses, runs["jax_loss"])


@pytest.mark.parametrize("n_stages", STAGES)
def test_gradients_match_jax_grad(runs, n_stages):
    gaps = runs["ranks"][n_stages]["grad_gaps"]
    assert len(gaps) == len(list(leaves(build(_cfg(), device="cpu").defs)))
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < 1e-3, (worst, gaps[worst])


@pytest.mark.parametrize("n_stages", STAGES)
def test_tied_embedding_gradient_sums_both_ends(runs, n_stages):
    """Stage 0's gather and the last stage's unembedding both reach
    ``embed.tok``; without the sum over the stages one end is missing."""
    assert _cfg().tie_embeddings
    assert runs["ranks"][n_stages]["grad_gaps"]["embed.tok"] < 1e-3


def _one_stage(remat, n_mb=N_MB):
    cfg = _cfg()
    model = build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    mesh = make_stage_mesh(1)
    ref = map_tree(lambda a: a.clone().requires_grad_(), params)
    want = model.loss(ref, batch, remat=remat)
    want.backward()
    mine = map_tree(lambda a: a.clone().requires_grad_(),
                    stage_params(params, cfg, mesh, n_stages=1))
    got = make_gpipe_loss(cfg, mesh, n_stages=1, n_microbatches=n_mb, remat=remat)(mine, batch)
    got.backward()
    gaps = {}
    have = dict(leaves(map_tree(lambda a: a.grad, mine)))
    for path, g in leaves(map_tree(lambda a: a.grad, ref)):
        gaps[path] = float((have[path] - g).abs().max()) / float(g.abs().max())
    return float(got.detach()), float(want.detach()), gaps


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n_mb", [1, N_MB])
def test_one_stage_equals_model_loss(remat, n_mb):
    got, want, gaps = _one_stage(remat, n_mb)
    assert abs(got - want) < 1e-6, (got, want)
    assert max(gaps.values()) < 1e-5, max(gaps.items(), key=lambda kv: kv[1])


def test_one_stage_mesh_without_a_group():
    mesh = make_stage_mesh(1)
    assert mesh == MeshSpec((1,), ("pod",))
    with pytest.raises(RuntimeError, match=r"a \(4,\) mesh needs a process group of 4 ranks"):
        make_stage_mesh(4)


def test_stage_params_keeps_the_replicated_roots():
    cfg = _cfg()
    params = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tree = stage_params(params, cfg, make_stage_mesh(1), n_stages=1)
    assert tree["embed"] is params["embed"] and tree["final_norm"] is params["final_norm"]
    for (path, a), (_, b) in zip(leaves(params), leaves(tree)):
        assert torch.equal(a, b), path


def test_without_grad_the_loss_builds_no_graph():
    cfg = _cfg()
    model = build(cfg, device="cpu")
    params = map_tree(lambda a: a.requires_grad_(),
                      model.init(torch.Generator().manual_seed(0)))
    toks = torch.zeros((BATCH, SEQ), dtype=torch.long)
    loss_fn = make_gpipe_loss(cfg, make_stage_mesh(1), n_stages=1, n_microbatches=N_MB)
    with torch.no_grad():
        loss = loss_fn(params, {"tokens": toks, "labels": toks})
    assert not loss.requires_grad and torch.isfinite(loss)


@pytest.mark.parametrize("n_stages,n_mb,want", [(1, 4, 0.0), (2, 4, 0.2), (4, 4, 3 / 7),
                                                (4, 8, 3 / 11)])
def test_bubble_fraction(n_stages, n_mb, want):
    assert bubble_fraction(n_stages, n_mb) == pytest.approx(want)


def test_what_the_pipeline_refuses():
    cfg = _cfg()
    mesh = make_stage_mesh(1)
    with pytest.raises(ValueError, match="dense family"):
        make_gpipe_loss(reduced(get_config("deepseek-moe-16b")), mesh, n_stages=1,
                        n_microbatches=1)
    with pytest.raises(ValueError, match="4 layers do not split into 3 stages"):
        make_gpipe_loss(cfg, mesh, n_stages=3, n_microbatches=1)
    with pytest.raises(ValueError, match="2 stages on a 'pod' axis of 1 ranks"):
        make_gpipe_loss(cfg, mesh, n_stages=2, n_microbatches=1)
    loss_fn = make_gpipe_loss(cfg, mesh, n_stages=1, n_microbatches=3)
    params = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    toks = torch.zeros((BATCH, SEQ), dtype=torch.long)
    with pytest.raises(ValueError, match="8 rows does not split into 3 microbatches"):
        loss_fn(params, {"tokens": toks, "labels": toks})
