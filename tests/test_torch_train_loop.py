"""The port's training loop and its substrate against the JAX package's, on
the CPU: the synthetic data bit for bit, checkpoints that either package
writes restored by the other bit for bit, retention and async writes,
the reference's own fault-tolerance tests run on the port's
``train_loop`` (a reduced smollm-135m, and the reduced zamba2-2.7b
hybrid: its loss falls, a resume repeats the uninterrupted run, two
microbatches agree with one), the CLI in a subprocess, and the
configurations that are not ported raising with their ROADMAP items.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jax_checkpointer
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.launch.train import train_loop as jax_train_loop
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import launch_counts
from repro_torch.launch.steps import accumulate_grads, loss_and_grads
from repro_torch.launch.train import train_loop
from repro_torch.models import build
from repro_torch.models.params import leaves
from repro_torch.optim import init_opt_state
from repro_torch.runtime import FaultInjector, StragglerWatchdog, elastic_restore

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("count,index", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_synthetic_batches_equal_the_reference(count, index):
    kw = dict(vocab=101, seq_len=24, global_batch=8, seed=7)
    ours = SyntheticLM(DataConfig(**kw), process_index=index, process_count=count)
    ref = JaxSyntheticLM(JaxDataConfig(**kw), process_index=index, process_count=count)
    assert ours.local_batch == ref.local_batch == 8 // count
    for step in (0, 1, 5, 123):
        a, b = ours.batch(step), ref.batch(step)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])


def test_synthetic_defaults_to_one_process_without_a_process_group():
    data = SyntheticLM(DataConfig(vocab=50, seq_len=8, global_batch=4))
    assert (data.pi, data.pc, data.local_batch) == (0, 1, 4)


def _model_state():
    """A reduced smollm-135m's params and an AdamW state with moments and
    step set, as torch tensors."""
    model = build(reduced(get_config("smollm-135m")), device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    opt = init_opt_state(params)
    opt["m"] = {k: v for k, v in opt["m"].items()}
    gen = torch.Generator().manual_seed(4)
    opt["v"] = jax.tree.map(lambda t: torch.rand(t.shape, generator=gen), opt["v"])
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    return {"params": params, "opt": opt, "extra": [torch.arange(3, dtype=torch.int32),
                                                    torch.ones(2, 2)]}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _model_state()
    checkpointer.save(tmp_path, 9, state)
    assert checkpointer.latest_step(tmp_path) == jax_checkpointer.latest_step(tmp_path) == 9
    like = jax.tree.map(lambda t: t.numpy(), state)
    back = jax_checkpointer.restore(tmp_path, 9, like)
    for (_, want), (_, got) in zip(jax.tree_util.tree_flatten_with_path(like)[0],
                                   jax.tree_util.tree_flatten_with_path(back)[0]):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # the same files and names the reference writes for the same tree
    jax_checkpointer.save(tmp_path / "ref", 9, like)
    ours = json.loads((tmp_path / "step_9" / "meta.json").read_text())
    theirs = json.loads((tmp_path / "ref" / "step_9" / "meta.json").read_text())
    assert ours == theirs
    assert "opt__step" in ours["keys"] and "extra__1" in ours["keys"]
    assert np.load(tmp_path / "step_9" / "opt__step.npy").shape == ()


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _model_state()
    host = jax.tree.map(lambda t: t.numpy(), state)
    jax_checkpointer.save(tmp_path, 4, jax.tree.map(jax.numpy.asarray, host))
    back = checkpointer.restore(tmp_path, 4, state)
    flat_back = dict(leaves({k: v for k, v in back.items() if k != "extra"}))
    for path, want in leaves({k: v for k, v in host.items() if k != "extra"}):
        np.testing.assert_array_equal(flat_back[path], want)
        assert flat_back[path].dtype == want.dtype
    for got, want in zip(back["extra"], host["extra"]):
        np.testing.assert_array_equal(got, want)
    placed = elastic_restore(tmp_path, 4, {"params": state["params"], "opt": state["opt"]},
                             torch.device("cpu"))
    assert placed["opt"]["step"].dtype == torch.int32 and int(placed["opt"]["step"]) == 7
    assert torch.equal(placed["params"]["embed"]["tok"], state["params"]["embed"]["tok"])


def test_checkpoint_retention_and_async(tmp_path):
    tree = {"x": np.ones((4,))}
    for s in (1, 2, 3, 4, 5):
        checkpointer.save(tmp_path, s, tree, keep=2)
    assert checkpointer.latest_step(tmp_path) == 5
    steps = sorted(p.name for p in pathlib.Path(tmp_path).glob("step_*"))
    assert steps == ["step_4", "step_5"]
    t = checkpointer.save_async(tmp_path, 6, {"x": torch.arange(4.0)})
    checkpointer.wait_for_saves()
    assert not t.is_alive()
    assert checkpointer.latest_step(tmp_path) == 6
    np.testing.assert_array_equal(np.load(tmp_path / "step_6" / "x.npy"), np.arange(4.0))


def test_bf16_checkpoint_leaf_raises(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        checkpointer.save(tmp_path, 1, {"w": torch.ones(2, dtype=torch.bfloat16)})


def test_restart_resumes_from_checkpoint(tmp_path):
    """tests/test_fault_tolerance.py's restart test on the port, plus: the
    resumed steps repeat an uninterrupted run's losses bit for bit."""
    cfg = reduced(get_config("smollm-135m"))
    kw = dict(steps=16, global_batch=2, seq_len=32, log_every=100, device="cpu")
    inj = FaultInjector(fail_at_steps=(12,))
    state, losses, _ = train_loop(cfg, ckpt_dir=str(tmp_path), ckpt_every=5,
                                  fault_injector=inj, **kw)
    assert 12 in inj.fired
    # steps 0..11, then from the checkpoint of step 10: 10..15
    assert len(losses) == 18 and np.isfinite(losses).all()
    assert checkpointer.latest_step(tmp_path) == 16
    _, clean, _ = train_loop(cfg, **kw)
    assert losses[:12] == clean[:12] and losses[12:] == clean[10:]
    assert int(state["opt"]["step"]) == 16


def test_checkpoint_holds_the_steps_its_name_counts_where_the_reference_repeats_one(tmp_path):
    """The one departure from the reference's loop, pinned. The reference
    saves at step N the state after N + 1 steps under ``step_N`` and
    resumes there at step N, so a resumed run takes step N's batch a
    second time and leaves the uninterrupted run's losses. The port's
    ``step_N`` holds the state after N steps, and its resumed run repeats
    the uninterrupted one bit for bit."""
    kw = dict(steps=7, global_batch=2, seq_len=32, ckpt_every=5, log_every=100)
    runs = {"reference": (jax_train_loop, jax_reduced(jax_get_config("smollm-135m")), {}),
            "port": (train_loop, reduced(get_config("smollm-135m")), {"device": "cpu"})}
    out = {}
    for name, (loop, cfg, extra) in runs.items():
        ckpt = tmp_path / name
        _, clean, _ = loop(cfg, ckpt_dir=str(ckpt), **kw, **extra)
        meta = json.loads((ckpt / "step_5" / "meta.json").read_text())
        taken = int(np.load(ckpt / "step_5" / "opt__step.npy"))
        # restart from step_5 alone: the run resumes at step 5
        for p in ckpt.glob("step_7*"):
            shutil.rmtree(p)
        _, resumed, _ = loop(cfg, ckpt_dir=str(ckpt), **kw, **extra)
        out[name] = (meta, taken, clean, resumed)
    ref_meta, ref_taken, ref_clean, ref_resumed = out["reference"]
    meta, taken, clean, resumed = out["port"]
    assert ref_meta["step"] == meta["step"] == 5
    assert ref_taken == 6 and taken == 5
    assert len(ref_resumed) == len(resumed) == 2
    assert resumed == clean[5:]
    assert ref_resumed[0] != ref_clean[5]


def test_loss_decreases_smoke():
    cfg = reduced(get_config("smollm-135m"))
    _, losses, _ = train_loop(cfg, steps=40, global_batch=4, seq_len=64, log_every=100,
                              device="cpu")
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_straggler_watchdog_flags_slow_step():
    wd = StragglerWatchdog(factor=3.0, warmup=3)
    for i in range(6):
        wd.start_step()
        time.sleep(0.01)
        wd.end_step(i)
    wd.start_step()
    time.sleep(0.2)
    assert wd.end_step(99) is True
    assert 99 in wd.slow_steps


def test_cli_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--steps", "3", "--json"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout)
    assert out["device"]["platform"] == "cpu" and out["steps"] == 3
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert not any(out["launches"].values())  # plain versions on the CPU


def test_train_loop_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(reduced(get_config("smollm-135m")), steps=1)


@pytest.fixture(scope="module")
def on_two_ranks(tmp_path_factory):
    """``train_loop`` at (2, 1) on two ``gloo`` ranks (tests/_torch_ranks.py)."""
    from _torch_ranks import run_ranks, shared

    return shared(tmp_path_factory, "train2", lambda work: run_ranks("train2", 2, work))


@pytest.mark.parametrize("kw", [{"mesh_shape": (2, 1)}, {"strategy": "megatron"}])
def test_multi_device_training(kw, on_two_ranks):
    """The calls that raised before the mesh was ported: at (2, 1) each
    rank holds its FSDP shards and trains on half the batch; at (1, 1)
    megatron trains as dos does. Both give one rank's losses (f32 sums in
    another order: 1e-5)."""
    cfg = reduced(get_config("smollm-135m"))
    run = dict(steps=2, global_batch=4, seq_len=32, log_every=0, device="cpu")
    want = train_loop(cfg, **run)[1]
    got = on_two_ranks["losses"] if "mesh_shape" in kw else train_loop(cfg, **run, **kw)[1]
    assert np.allclose(got, want, rtol=0, atol=1e-5), (got, want)


def test_training_another_family_on_a_mesh_matches_one_rank(on_two_ranks):
    """xlstm-125m (ssm), which raised on a mesh before the other families
    were sharded, trained at (1, 2): one rank's losses, the first within
    1e-5 (the same weights), the next within 1e-5 of themselves (AdamW's
    first update amplifies the f32 sums' order: tests/
    test_torch_sharding_families.py)."""
    from _torch_ranks import OTHER_TRAIN

    want = train_loop(reduced(get_config("xlstm-125m")), **OTHER_TRAIN, device="cpu")[1]
    got = on_two_ranks["xlstm"]
    assert len(got) == len(want) and abs(got[0] - want[0]) < 1e-5, (got, want)
    assert np.allclose(got[1:], want[1:], rtol=1e-5, atol=0), (got, want)


@pytest.mark.parametrize("arch,kw,match", [
    ("whisper-medium", {}, "tokens and labels only.*make_train_step with 'enc_frames'"),
    ("llama-3.2-vision-11b", {}, "tokens and labels only.*make_train_step with 'image_embeds'"),
])
def test_not_ported_configurations_name_their_roadmap_items(arch, kw, match):
    # the vision and encoder-decoder models train through make_train_step,
    # as the reference's train_loop cannot feed them
    # (test_reference_train_loop_cannot_feed_these_families)
    with pytest.raises(NotImplementedError, match=match):
        train_loop(reduced(get_config(arch)), steps=1, device="cpu", **kw)


@pytest.mark.parametrize("arch,missing", [("llama-3.2-vision-11b", "shape"),
                                          ("whisper-medium", "astype")])
def test_reference_train_loop_cannot_feed_these_families(arch, missing):
    """The reference's train_loop feeds SyntheticLM's tokens and labels only:
    its vision forward calls compute_cross_kv on image_embeds=None, its
    encoder-decoder forward encode(params, None), and both fail, which the
    port's refusal above follows."""
    with pytest.raises(AttributeError, match=f"'NoneType' object has no attribute '{missing}'"):
        jax_train_loop(jax_reduced(jax_get_config(arch)), steps=1, global_batch=2, seq_len=16,
                       log_every=100)


def test_hybrid_loss_is_differentiable_in_every_leaf():
    """The reduced hybrid's loss has a finite gradient in every leaf, and
    none is zero: the scan's backward reaches B, C, the decays and D."""
    model = build(reduced(get_config("zamba2-2.7b")), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, model.cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(1))
    loss, grads = loss_and_grads(model, params, {"tokens": tokens, "labels": tokens.roll(-1, 1)},
                                 True)
    assert np.isfinite(float(loss))
    for path, g in leaves(grads):
        assert bool(torch.isfinite(g).all()) and g.abs().max() > 0, path


def _hybrid_kw(**kw):
    return dict(dict(steps=16, global_batch=2, seq_len=32, log_every=100, device="cpu"), **kw)


def test_hybrid_train_loop_loss_falls_without_launches():
    cfg = reduced(get_config("zamba2-2.7b"))
    before = launch_counts()
    _, losses, _ = train_loop(cfg, **_hybrid_kw(steps=25))
    assert launch_counts() == before  # plain versions on the CPU
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_hybrid_restart_resumes_from_checkpoint(tmp_path):
    """A fault at step 12 of the reduced hybrid: the loop resumes from the
    checkpoint of step 10 and its losses repeat an uninterrupted run's bit
    for bit; the checkpoint holds the hybrid's tree in the reference's
    layout, so the reference restores it."""
    cfg = reduced(get_config("zamba2-2.7b"))
    inj = FaultInjector(fail_at_steps=(12,))
    state, losses, _ = train_loop(cfg, ckpt_dir=str(tmp_path), ckpt_every=5,
                                  fault_injector=inj, **_hybrid_kw())
    assert 12 in inj.fired and len(losses) == 18
    _, clean, _ = train_loop(cfg, **_hybrid_kw())
    assert losses[:12] == clean[:12] and losses[12:] == clean[10:]
    like = jax.tree.map(lambda t: t.numpy(), {"params": state["params"], "opt": state["opt"]})
    back = jax_checkpointer.restore(tmp_path, 16, like)
    for (path, want), (_, got) in zip(jax.tree_util.tree_flatten_with_path(like)[0],
                                      jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_hybrid_microbatches_agree_with_one():
    """Two microbatches of the reduced hybrid: the accumulated gradients
    equal the full batch's leaf by leaf within 1e-5 of the leaf's max|g|
    (f32 sums in another order), and 3 steps of train_loop give the same
    losses within 5e-3 (tests/test_models_smoke.py's band for the
    reference)."""
    cfg = reduced(get_config("zamba2-2.7b"))
    model = build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(x)
             for k, x in SyntheticLM(DataConfig(cfg.vocab, 32, 2, seed=0)).batch(0).items()}
    loss, grads = loss_and_grads(model, params, batch, True)
    acc_loss, acc = accumulate_grads(model, params, batch, True, 2)
    assert abs(float(acc_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    flat = dict(leaves(acc))
    for path, want in leaves(grads):
        assert (flat[path] - want).abs().max() <= 1e-5 * want.abs().max(), path
    _, one, _ = train_loop(cfg, **_hybrid_kw(steps=3))
    _, two, _ = train_loop(cfg, microbatches=2, **_hybrid_kw(steps=3))
    assert max(abs(a - b) for a, b in zip(one, two)) < 5e-3, (one, two)
