"""The port's training step against the JAX package's, on the CPU,
with the same weights (the reference's parameters exported through
numpy, norm scales, qkv biases and Mamba2's ``D`` and ``dt_bias``
randomised so that they are tested) and the same batches.

Per reduced config (smollm-135m; gemma3-1b with its window and global
layers, the window binding at 80 tokens; qwen2.5-3b with qkv biases;
qwen2-72b with an untied head; zamba2-2.7b, the hybrid: 2 groups of 2
Mamba2 layers and the shared block, 80 tokens so that the scan runs two
whole chunks and a ragged one, its remat recomputing each Mamba2 layer):
- ``Model.loss`` against the reference's ``model.loss``, remat off, on
  and ``"save_gathered"``: within 1e-5 of the loss (f32 on both sides,
  summed in other orders);
- every gradient leaf against ``jax.grad``: within 1e-3 of the leaf's
  largest entry (the reference's bound for gradients crossing two
  frameworks; the differences measured are ~1e-6);
- remat (either policy) changes nothing in the port: the same loss and
  gradients, bit for bit.

The optimizer on identical numpy params, grads and state: the update
and the schedule within f32 rounding (4 ulp of each leaf's scale:
the same formulas in the same order; pow, sqrt and cos may differ in
their last bit). The loss trajectory of 3 train steps against the
reference's jitted step, at microbatches 1 and 2 (1e-5 of the loss; the
parameters within 1e-3 of each leaf's scale after 3 AdamW steps: Adam
normalises each element's gradient, so an element whose gradient is ~0
moves by up to the learning rate in a direction that rounding sets,
4e-5 measured against steps of 1e-3), and
the microbatched loss against the full batch's (5e-3 absolute, as
tests/test_models_smoke.py holds the reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build as jax_build
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state
from repro.optim import schedule as jax_schedule
from repro_torch.configs import get_config, reduced
from repro_torch.launch.steps import accumulate_grads, loss_and_grads, make_train_step
from repro_torch.models import build
from repro_torch.models.convert import from_numpy, opt_state_from_numpy
from repro_torch.models.params import leaves
from repro_torch.optim import OptConfig, adamw_update, schedule

BATCH = 2
# arch -> sequence length (gemma3's reduced window is 64: 80 makes it bind)
CONFIGS = {"smollm-135m": 32, "gemma3-1b": 80, "qwen2.5-3b": 32, "qwen2-72b": 32,
           "zamba2-2.7b": 80}


def _randomize(tree, rng):
    """Random norm scales and biases (their init is ones and zeros)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "norm", "D"):
            out[k] = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(v.dtype)
        elif k in ("bq", "bk", "bv", "dt_bias"):
            out[k] = (0.1 * rng.normal(size=v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _setup(name, seq, seed=0):
    jcfg, cfg = jax_reduced(jax_get_config(name)), reduced(get_config(name))
    jmodel, model = jax_build(jcfg), build(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    params_np = _randomize(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed))), rng)
    tokens = rng.integers(0, cfg.vocab, (BATCH * 2, seq)).astype(np.int32)
    batch_np = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    return jmodel, model, params_np, batch_np


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch_batch(batch_np):
    return {k: torch.from_numpy(v) for k, v in batch_np.items()}


def _flat_np(tree):
    return {path: np.asarray(x) for path, x in leaves(tree)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def grads_run(request):
    jmodel, model, params_np, batch_np = _setup(request.param, CONFIGS[request.param])
    out = {"name": request.param}
    # the reference's gradients once (its remat changes no value), its loss
    # with remat off and on
    jl, jg = jax.jit(jax.value_and_grad(jmodel.loss))(_jax(params_np), _jax(batch_np))
    jg = _flat_np(jax.tree.map(np.asarray, jg))
    jl_remat = jax.jit(lambda p, b: jmodel.loss(p, b, remat=True))(_jax(params_np),
                                                                   _jax(batch_np))
    for remat, jloss in ((False, jl), (True, jl_remat), ("save_gathered", jl_remat)):
        tl, tg = loss_and_grads(model, from_numpy(model, params_np), _torch_batch(batch_np),
                                remat)
        out[remat] = (float(jloss), jg, float(tl), {p: g.numpy() for p, g in leaves(tg)})
    return out


@pytest.mark.parametrize("remat", [False, True, "save_gathered"])
def test_loss_matches_reference(grads_run, remat):
    jl, _, tl, _ = grads_run[remat]
    assert np.isfinite(tl)
    assert abs(tl - jl) <= 1e-5 * abs(jl), (grads_run["name"], tl, jl)


@pytest.mark.parametrize("remat", [False, True, "save_gathered"])
def test_every_gradient_leaf_matches_reference(grads_run, remat):
    _, jg, _, tg = grads_run[remat]
    assert tg.keys() == jg.keys()
    for path, want in jg.items():
        got = tg[path]
        assert got.shape == want.shape and got.dtype == np.float32, path
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-3 * scale, (grads_run["name"], path)


@pytest.mark.parametrize("remat", [True, "save_gathered"])
def test_remat_gives_the_same_gradients(grads_run, remat):
    assert grads_run[remat][2] == grads_run[False][2]
    for path, g in grads_run[False][3].items():
        np.testing.assert_array_equal(grads_run[remat][3][path], g, err_msg=str(path))


def _random_tree(rng, positive=False):
    tree = {"a": rng.normal(size=(3, 5)), "b": {"c": rng.normal(size=(7,)),
                                                "d": rng.normal(size=(2, 2, 4))}}
    return jax.tree.map(lambda x: np.abs(x).astype(np.float32) if positive
                        else x.astype(np.float32), tree)


def _close_ulps(got, want, ulps=4):
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= ulps * np.spacing(np.float32(scale))


@pytest.mark.parametrize("step", [0, 4, 57])
def test_adamw_update_and_schedule_match_reference(step):
    rng = np.random.default_rng(step)
    params, grads, m = _random_tree(rng), _random_tree(rng), _random_tree(rng)
    v = _random_tree(rng, positive=True)
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100, clip_norm=0.5)
    jcfg, cfg = JaxOptConfig(**kw), OptConfig(**kw)
    jstate = {"m": _jax(m), "v": _jax(v), "step": jnp.int32(step)}
    jp, js, jn = jax_adamw_update(_jax(params), _jax(grads), jstate, jcfg)
    tstate = {"m": jax.tree.map(torch.tensor, m), "v": jax.tree.map(torch.tensor, v),
              "step": torch.tensor(step, dtype=torch.int32)}
    tp, ts, tn = adamw_update(jax.tree.map(torch.tensor, params),
                              jax.tree.map(torch.from_numpy, grads), tstate, cfg)
    _close_ulps(tn.numpy(), np.asarray(jn))
    assert int(ts["step"]) == int(js["step"]) == step + 1 and ts["step"].dtype == torch.int32
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for path, w in _flat_np(jax.tree.map(np.asarray, want)).items():
            g = dict(leaves(got))[path].numpy()
            assert g.dtype == np.float32
            _close_ulps(g, w)
    for s in (0, 1, 9, 10, 11, 55, 100, 140):
        _close_ulps(schedule(cfg, s).numpy(), np.asarray(jax_schedule(jcfg, s)))


@pytest.mark.parametrize("step", [0, 57])
def test_adamw_update_writes_into_the_given_tensors(step):
    """The update is in place (train_loop's step donates its state, as
    the reference's jitted step does): it returns the given params and
    moments, updated, and a fresh step counter; clones taken before are
    untouched, and a second update of those clones gives the same bits.
    A leaf that is not f32 cannot be updated in place and raises."""
    rng = np.random.default_rng(100 + step)
    params, grads, m, v = [jax.tree.map(torch.from_numpy, _random_tree(rng, positive=(i == 3)))
                           for i in range(4)]
    cfg = OptConfig(lr=3e-3, warmup_steps=10, total_steps=100, clip_norm=0.5)
    state = {"m": m, "v": v, "step": torch.tensor(step, dtype=torch.int32)}
    before = jax.tree.map(torch.clone, {"p": params, "m": m, "v": v, "step": state["step"]})
    got_p, got_s, got_n = adamw_update(params, grads, state, cfg)
    again_p, again_s, again_n = adamw_update(*jax.tree.map(torch.clone, (
        before["p"], grads, {"m": before["m"], "v": before["v"], "step": before["step"]})), cfg)
    assert int(got_s["step"]) == step + 1 and int(state["step"]) == step
    assert torch.equal(got_n, again_n)
    for got, given, old, again in ((got_p, params, before["p"], again_p),
                                   (got_s["m"], m, before["m"], again_s["m"]),
                                   (got_s["v"], v, before["v"], again_s["v"])):
        for (path, g), (_, d), (_, o), (_, a) in zip(leaves(got), leaves(given), leaves(old),
                                                     leaves(again)):
            assert g is d and torch.equal(g, a) and not torch.equal(g, o), path
    bf16 = jax.tree.map(lambda t: t.to(torch.bfloat16), before["p"])
    with pytest.raises(TypeError, match="f32"):
        adamw_update(bf16, grads, {"m": before["m"], "v": before["v"],
                                   "step": before["step"]}, cfg)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_trajectory_matches_reference(microbatches):
    jmodel, model, params_np, batch_np = _setup("smollm-135m", 32, seed=1)
    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    # the reference without remat (it changes no value and compiles faster)
    jstep = jax.jit(jax_make_train_step(jmodel, JaxOptConfig(**opt_kw), remat=False,
                                        microbatches=microbatches))
    tstep = make_train_step(model, OptConfig(**opt_kw), microbatches=microbatches)
    jp = _jax(params_np)
    jo = jax_init_opt_state(jp)
    tp = from_numpy(model, params_np)
    to = opt_state_from_numpy(model, jax.tree.map(np.asarray, jo))
    for i in range(3):
        batch = {k: np.roll(v, i, axis=0) for k, v in batch_np.items()}
        jp, jo, jl = jstep(jp, jo, _jax(batch))
        tp, to, tl = tstep(tp, to, _torch_batch(batch))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl)), (i, float(tl), float(jl))
    assert int(to["step"]) == 3
    for path, want in _flat_np(jax.tree.map(np.asarray, jp)).items():
        got = dict(leaves(tp))[path].numpy()
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), path


def test_microbatched_loss_equals_full_batch():
    _, model, params_np, batch_np = _setup("smollm-135m", 16, seed=4)
    params = from_numpy(model, params_np)
    full = float(model.loss(params, _torch_batch(batch_np)))
    step = make_train_step(model, OptConfig(lr=0.0, weight_decay=0.0), microbatches=2)
    from repro_torch.optim import init_opt_state

    _, _, loss = step(params, init_opt_state(params), _torch_batch(batch_np))
    assert abs(float(loss) - full) < 5e-3, (float(loss), full)


@pytest.mark.parametrize("microbatches", [2, 4])
def test_accumulated_gradients_equal_the_full_batch(microbatches):
    """The gradients the microbatched step updates with: each part's
    summed in f32 and divided by the count equal the full batch's, leaf by
    leaf within 1e-5 of the leaf's max|g| (f32 sums in another order); one
    part alone or the undivided sum is far outside."""
    _, model, params_np, batch_np = _setup("smollm-135m", 16, seed=5)
    params, batch = from_numpy(model, params_np), _torch_batch(batch_np)
    loss, grads = loss_and_grads(model, params, batch, True)
    acc_loss, acc = accumulate_grads(model, params, batch, True, microbatches)
    assert abs(float(acc_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    _, one = loss_and_grads(model, params, {k: v[:BATCH * 2 // microbatches]
                                            for k, v in batch.items()}, True)
    flat, flat_one = dict(leaves(acc)), dict(leaves(one))
    for path, want in leaves(grads):
        scale = want.abs().max().item()
        assert (flat[path] - want).abs().max().item() <= 1e-5 * scale, path
        assert (flat[path] * microbatches - want).abs().max().item() > 1e-2 * scale, path
    assert max((flat_one[p] - w).abs().max().item() / w.abs().max().item()
               for p, w in leaves(grads)) > 1e-2
