"""The port's xLSTM (the decoder's ``ssm`` branch: mLSTM and sLSTM
blocks) against the JAX package's, with the same weights: the
reference's parameters are exported through numpy and loaded through the
port's weight bridge. Norm scales and the forget-gate biases ``bf`` are
set to random values first, so that they are tested (their init is
ones).

At ``reduced(xlstm-125m)`` (4 blocks, sLSTM at block 1, d_model 128, 4
heads: mLSTM N = P = 16, sLSTM head width 32), f32 compute:
- the parameter tree: the walkers' order is ``jax.tree.leaves``' order,
  the bridge carries every leaf, ``compute_cast`` keeps the leaves the
  reference reads in f32, AdamW's global norm equals the reference's;
- the prefill logits and every block's state, then 8 decode steps
  teacher-forced on the reference's greedy tokens, each step's logits
  and the final states: within 1e-4 of max|ref| (the same f32 arithmetic
  summed in other orders; the 40-token prompt runs a whole and a ragged
  chunk of the scans);
- ``mlstm_block`` and ``slstm_block`` alone in every mode;
- ``Model.loss`` within 1e-5 of the reference's and every gradient leaf
  within 1e-3 of the leaf's max|g| (remat off and on: neither package
  rematerialises this branch);
- ``serve_loop``'s greedy tokens equal to the reference's greedy loop on
  the same weights and prompts; ``train_loop`` and both CLIs on the CPU.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build as jax_build
from repro.models import xlstm as jax_xlstm
from repro.optim.adamw import global_norm as jax_global_norm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import launch_counts
from repro_torch.launch.serve import serve_loop
from repro_torch.launch.steps import loss_and_grads
from repro_torch.launch.train import train_loop
from repro_torch.models import build
from repro_torch.models import xlstm
from repro_torch.models.convert import from_numpy
from repro_torch.models.params import compute_cast, leaves, map_tree
from repro_torch.optim import global_norm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "xlstm-125m"
TOL = 1e-4
DECODE_STEPS = 8
PROMPT = 40  # one whole chunk of 32 and a ragged one
BATCH = 2


def _cfgs():
    return jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))


def _randomize(tree, rng):
    """Random norm scales and forget-gate biases (their init is ones)."""
    if isinstance(tree, list):
        return [_randomize(v, rng) for v in tree]
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = _randomize(v, rng)
        elif k in ("ln", "final_norm", "norm"):
            out[k] = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(v.dtype)
        elif k == "bf":
            out[k] = (1.0 + 0.5 * rng.normal(size=v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _states(cache):
    """Copies of the blocks' states as numpy, the port's or the
    reference's (the port's decode writes its cache in place)."""
    return [{k: np.array(t) for k, t in st.items()} for st in cache["blocks"]]


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def _close_states(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            _close(g[k], r[k])


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _cfgs()
    jmodel, model = jax_build(jcfg), build(cfg, device="cpu")
    params_np = _randomize(_np(jmodel.init(jax.random.PRNGKey(0))), np.random.default_rng(0))
    return jcfg, cfg, jmodel, model, params_np


@pytest.fixture(scope="module")
def run(setup):
    _, cfg, jmodel, model, params_np = setup
    params = from_numpy(model, params_np)
    jparams = jax.tree.map(jnp.asarray, params_np)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (BATCH, PROMPT))
    max_len = PROMPT + DECODE_STEPS + 1
    jl, jcache = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, max_len=max_len))(
        jparams, jnp.asarray(tokens, jnp.int32))
    before = launch_counts()
    tl, tcache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, max_len=max_len)
    out = {"prefill": (np.asarray(jl), tl), "cache": (_states(_np(jcache)), _states(tcache)),
           "length": tcache["length"], "steps": []}
    jdecode = jax.jit(jmodel.decode)
    tok = np.asarray(jl)[:, -1:].argmax(-1)
    for _ in range(DECODE_STEPS):
        jl, jcache = jdecode(jparams, jcache, {"token": jnp.asarray(tok, jnp.int32)})
        tl, tcache = model.decode(params, tcache, {"token": torch.from_numpy(tok)})
        out["steps"].append((np.asarray(jl), tl))
        tok = np.asarray(jl).argmax(-1)  # teacher-forced on the reference
    out["final"] = (_states(_np(jcache)), _states(tcache), tcache["length"])
    out["launches"] = (before, launch_counts())
    return out


def test_leaves_follow_jax_flattening_order(setup):
    """``leaves`` walks the list of blocks by index and each dict by sorted
    keys: the order of ``jax.tree.leaves``, which AdamW's global norm and
    the checkpoints follow."""
    params_np = setup[4]
    flat, _ = jax.tree_util.tree_flatten_with_path(params_np)
    want = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path) for path, _ in flat]
    got = list(leaves(params_np))
    assert [p for p, _ in got] == want
    assert all(a is b for (_, a), (_, b) in zip(got, flat))
    assert isinstance(params_np["blocks"], list) and want[0][:2] == ("blocks", 0)


def test_weight_bridge_takes_the_list_tree(setup):
    """Every leaf crosses unchanged, the list stays a list."""
    _, _, _, model, params_np = setup
    params = from_numpy(model, params_np)
    assert isinstance(params["blocks"], list) and len(params["blocks"]) == 4
    assert set(params["blocks"][1]) == {"kind_slstm", "ln"}
    want = dict(leaves(params_np))
    got = dict(leaves(params))
    assert want.keys() == got.keys()
    for path, t in got.items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), want[path])


def test_compute_cast_keeps_the_leaves_the_reference_reads_in_f32(setup):
    _, _, _, model, params_np = setup
    cast = compute_cast(from_numpy(model, params_np), torch.bfloat16)
    kept = {"ln", "final_norm", "norm", "bf", "r"}
    for path, t in leaves(cast):
        want = torch.float32 if path[-1] in kept else torch.bfloat16
        assert t.dtype == want, path
    assert isinstance(cast["blocks"], list)


def test_global_norm_matches_reference(setup):
    _, _, _, model, params_np = setup
    want = float(jax_global_norm(jax.tree.map(jnp.asarray, params_np)))
    got = float(global_norm(from_numpy(model, params_np)))
    assert abs(got - want) <= 1e-6 * want


def test_param_count_and_empty_cache(setup):
    jcfg, cfg, jmodel, model, _ = setup
    assert model.n_params == jmodel.n_params
    full = build(get_config(ARCH), device="cpu")
    assert full.n_params == jax_build(jax_get_config(ARCH)).n_params == 66_153_264
    tcache = model.init_cache(2, 6, torch.float32)
    _close_states(_states(tcache), _states(_np(jmodel.init_cache(2, 6, jnp.float32))))
    assert tcache["length"] == 0


def test_prefill_logits(run):
    ref, got = run["prefill"]
    assert got.dtype == torch.float32
    _close(got, ref)


def test_prefill_cache(run):
    ref, got = run["cache"]
    _close_states(got, ref)
    assert run["length"] == PROMPT


def test_decode_logits_and_states(run):
    for ref, got in run["steps"]:
        _close(got, ref)
    ref, got, length = run["final"]
    _close_states(got, ref)
    assert length == PROMPT + DECODE_STEPS


def test_cpu_path_launches_no_kernel(run):
    before, after = run["launches"]
    assert before == after


def _block_case(setup, kind, mode):
    """One block of the reduced model on the CPU against the reference's:
    inputs and states from a seed, the block's own parameters."""
    jcfg, cfg, _, _, params_np = setup
    idx = cfg.slstm_at[0] if kind == "slstm" else 0
    p_np = params_np["blocks"][idx]["kind_" + kind]
    rng = np.random.default_rng(5)
    s = 1 if mode == "decode" else 37
    x = rng.normal(size=(BATCH, s, cfg.d_model)).astype(np.float32)
    init = getattr(jax_xlstm, f"{kind}_init_state")(jcfg, BATCH)
    state = None
    if mode == "decode":  # a state a prefill would leave: random, n and c of either sign
        state = {k: (rng.normal(size=v.shape) * (1.0 if k != "n" else 2.0)).astype(np.float32)
                 for k, v in _np(init).items()}
        if kind == "slstm":
            state["n"] = np.abs(state["n"]) + 0.5
    jblock = getattr(jax_xlstm, f"{kind}_block")
    jy, jst = jblock(jax.tree.map(jnp.asarray, p_np), jnp.asarray(x), jcfg, mode=mode,
                     state=None if state is None else jax.tree.map(jnp.asarray, state))
    tblock = getattr(xlstm, f"{kind}_block")
    ty, tst = tblock(map_tree(torch.tensor, p_np), torch.from_numpy(x), cfg, mode=mode,
                     state=None if state is None else map_tree(torch.from_numpy, state))
    return (np.asarray(jy), ty), (_np(jst), tst)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_block_alone_matches_reference(setup, kind, mode):
    (jy, ty), (jst, tst) = _block_case(setup, kind, mode)
    _close(ty, jy)
    assert jst.keys() == tst.keys()
    for k in jst:
        _close(tst[k], jst[k])


@pytest.fixture(scope="module")
def grads(setup):
    _, cfg, jmodel, model, params_np = setup
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    batch_np = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    jl, jg = jax.jit(jax.value_and_grad(jmodel.loss))(jax.tree.map(jnp.asarray, params_np),
                                                      jax.tree.map(jnp.asarray, batch_np))
    jg = {p: np.asarray(g) for p, g in leaves(_np(jg))}
    out = {}
    for remat in (False, True):
        tl, tg = loss_and_grads(model, from_numpy(model, params_np),
                                {k: torch.from_numpy(v) for k, v in batch_np.items()}, remat)
        out[remat] = (float(jl), jg, float(tl), {p: g.numpy() for p, g in leaves(tg)})
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_loss_matches_reference(grads, remat):
    jl, _, tl, _ = grads[remat]
    assert np.isfinite(tl)
    assert abs(tl - jl) <= 1e-5 * abs(jl)


@pytest.mark.parametrize("remat", [False, True])
def test_every_gradient_leaf_matches_reference(grads, remat):
    _, jg, _, tg = grads[remat]
    assert jg.keys() == tg.keys()
    for path, want in jg.items():
        got = tg[path]
        assert got.shape == want.shape and np.isfinite(got).all(), path
        assert np.abs(got - want).max() <= 1e-3 * max(np.abs(want).max(), 1e-30), path
        assert np.abs(want).max() > 0, path  # the gradient reaches every leaf


def test_remat_changes_nothing(grads):
    _, _, l0, g0 = grads[False]
    _, _, l1, g1 = grads[True]
    assert l0 == l1
    for path in g0:
        np.testing.assert_array_equal(g0[path], g1[path])


def test_serve_loop_greedy_tokens_match_reference():
    """``serve_loop`` on the CPU draws its weights and prompts from the
    seed; the same weights and prompts through the reference's greedy
    loop give the same tokens."""
    jcfg, cfg = _cfgs()
    batch, prompt_len, gen_tokens, seed = 2, 24, 6, 3
    got = serve_loop(cfg, batch=batch, prompt_len=prompt_len, gen_tokens=gen_tokens,
                     seed=seed, device="cpu")
    assert not any(got["launches"]["prefill"].values())
    assert not any(got["launches"]["decode"].values())
    model = build(cfg, device="cpu")
    params = model.compute_params(model.init(torch.Generator().manual_seed(seed)))
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(seed + 1))
    jmodel = jax_build(jcfg)
    jparams = jax.tree.map(jnp.asarray, map_tree(lambda t: t.numpy(), params))
    logits, cache = jax.jit(
        lambda p, t: jmodel.prefill(p, {"tokens": t}, max_len=prompt_len + gen_tokens)
    )(jparams, jnp.asarray(prompts.numpy(), jnp.int32))
    tok = jnp.argmax(logits[:, -1:], axis=-1)
    want = [tok]
    decode = jax.jit(jmodel.decode)
    for _ in range(gen_tokens - 1):
        logits, cache = decode(jparams, cache, {"token": tok})
        tok = jnp.argmax(logits, axis=-1)
        want.append(tok)
    np.testing.assert_array_equal(got["generated"].numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))


def test_train_loop_loss_falls_without_launches():
    before = launch_counts()
    _, losses, _ = train_loop(reduced(get_config(ARCH)), steps=12, global_batch=2, seq_len=32,
                              log_every=100, device="cpu")
    assert launch_counts() == before  # plain versions on the CPU
    assert np.isfinite(losses).all() and len(losses) == 12
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


@pytest.mark.parametrize("cmd", [
    ["repro_torch.launch.serve", "--arch", ARCH, "--smoke", "--device", "cpu", "--json",
     "--gen-tokens", "4"],
    ["repro_torch.launch.train", "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
     "--json"],
])
def test_cli_runs_xlstm_on_the_cpu(cmd):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", *cmd], capture_output=True, text=True,
                       timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout)
    assert out["device"]["platform"] == "cpu"
    launches = out["launches"]
    for phase in (launches.values() if "prefill" in launches else [launches]):
        assert not any(phase.values())
