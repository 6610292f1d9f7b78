"""The port's dense decoder against the JAX package's, with the same
weights: the reference's parameters are exported through numpy and
loaded through the port's weight bridge. Norm scales and qkv biases are
set to random values first, so that qk_norm and the biases are tested
(their init is ones and zeros).

Per config: the prefill logits and KV cache, then 8 decode steps
teacher-forced on the reference's greedy tokens (so a near-tie cannot
split the two sequences), each step's logits, and the greedy token
wherever the reference's top-2 margin exceeds the tolerance.

Tolerance: max|diff| <= 1e-4 * max|ref| in f32 compute. Both sides run
the same f32 arithmetic; XLA and torch differ in summation order and in
the last bits of exp/log/rsqrt, and those differences pass through every
layer, so the logits agree to about 1e-6 of their scale, not bit for
bit. A wrong mask, position, head grouping or weight layout moves them
by the order of their scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build as jax_build
from repro_torch.configs import get_config, reduced
from repro_torch.models import build
from repro_torch.models.convert import from_numpy

TOL = 1e-4
DECODE_STEPS = 8

# name, prompt length, reduced?  gemma3's prompt is longer than its
# reduced 64-token window, so the window binds in prefill and in decode.
CONFIGS = {
    "smollm-135m-reduced": ("smollm-135m", 24, True),
    "gemma3-1b-reduced": ("gemma3-1b", 80, True),
    "qwen2.5-3b-reduced": ("qwen2.5-3b", 24, True),
    "smollm-135m-2layers": ("smollm-135m", 16, False),  # full widths, vocab 49152
}


def _cfgs(name, is_reduced):
    if is_reduced:
        return jax_reduced(jax_get_config(name)), reduced(get_config(name))
    kw = dict(n_layers=2, compute_dtype="float32")
    return (dataclasses.replace(jax_get_config(name), **kw),
            dataclasses.replace(get_config(name), **kw))


def _randomize(tree, rng):
    """Random norm scales and biases (their init is ones and zeros)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("ln1", "ln2", "final_norm", "q_norm", "k_norm"):
            out[k] = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(v.dtype)
        elif k in ("bq", "bk", "bv"):
            out[k] = (0.1 * rng.normal(size=v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request):
    name, prompt_len, is_reduced = CONFIGS[request.param]
    jcfg, cfg = _cfgs(name, is_reduced)
    jmodel = jax_build(jcfg)
    params_np = _randomize(
        jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        np.random.default_rng(0),
    )
    model = build(cfg, device="cpu")
    params = from_numpy(model, params_np)
    jparams = jax.tree.map(jnp.asarray, params_np)

    batch = 2
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (batch, prompt_len))
    max_len = prompt_len + DECODE_STEPS + 1
    jl, jcache = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, max_len=max_len))(
        jparams, jnp.asarray(tokens, jnp.int32))
    tl, tcache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, max_len=max_len)
    out = {
        "prefill": (np.asarray(jl), tl.numpy()),
        # a copy: the port's decode writes its cache in place
        "cache": (jax.tree.map(np.asarray, jcache),
                  {"layers": {n: t.clone() for n, t in tcache["layers"].items()},
                   "length": tcache["length"]}),
        "steps": [],
    }
    jdecode = jax.jit(jmodel.decode)
    tok = np.asarray(jl)[:, -1:].argmax(-1)
    for _ in range(DECODE_STEPS):
        jl, jcache = jdecode(jparams, jcache, {"token": jnp.asarray(tok, jnp.int32)})
        tl, tcache = model.decode(params, tcache, {"token": torch.from_numpy(tok)})
        out["steps"].append((np.asarray(jl), tl.numpy()))
        tok = np.asarray(jl).argmax(-1)  # teacher-forced on the reference
    out["final_cache"] = (jax.tree.map(np.asarray, jcache), tcache)
    return out


def _close(got, ref):
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_prefill_logits(run):
    ref, got = run["prefill"]
    assert got.dtype == np.float32
    _close(got, ref)


def test_prefill_cache(run):
    ref, got = run["cache"]
    assert got["length"] == int(ref["layers"]["length"][0])
    for name in ("k", "v"):
        _close(got["layers"][name].numpy(), ref["layers"][name])


def test_decode_logits_and_cache(run):
    for ref, got in run["steps"]:
        _close(got, ref)
    ref, got = run["final_cache"]
    assert got["length"] == int(ref["layers"]["length"][0])
    for name in ("k", "v"):
        _close(got["layers"][name].numpy(), ref["layers"][name])


def test_greedy_tokens_agree_where_decided(run):
    checked = 0
    for ref, got in [run["prefill"]] + run["steps"]:
        ref, got = ref[:, -1], got[:, -1]
        top2 = np.sort(ref, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * TOL * np.abs(ref).max()
        assert np.array_equal(got.argmax(-1)[decided], ref.argmax(-1)[decided])
        checked += int(decided.sum())
    assert checked > 0


def test_decode_from_empty_cache_and_param_count():
    """``init_cache`` + decode from an empty cache, and ``n_params``,
    against the reference's."""
    jcfg, cfg = _cfgs("gemma3-1b", True)
    jmodel, model = jax_build(jcfg), build(cfg, device="cpu")
    assert model.n_params == jmodel.n_params
    params_np = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    params = from_numpy(model, params_np)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jcache = jmodel.init_cache(2, 6, jnp.float32)
    tcache = model.init_cache(2, 6, torch.float32)
    assert tuple(tcache["layers"]["k"].shape) == jcache["layers"]["k"].shape
    jdecode = jax.jit(jmodel.decode)
    for tok in np.random.default_rng(2).integers(0, cfg.vocab, (4, 2, 1)):
        jl, jcache = jdecode(jparams, jcache, {"token": jnp.asarray(tok, jnp.int32)})
        tl, tcache = model.decode(params, tcache, {"token": torch.from_numpy(tok)})
        _close(tl.numpy(), np.asarray(jl))
