"""The port's hybrid decoder (zamba2: Mamba2 groups + a weight-shared
attention block) against the JAX package's, with the same weights: the
reference's parameters are exported through numpy and loaded through
the port's weight bridge. Norm scales, Mamba2's ``D`` and ``dt_bias``
are set to random values first, so that they are tested (their init is
ones and zeros).

Per config: the prefill logits and every cache leaf (conv and SSM state
of every Mamba2 layer, the shared block's k/v of every group), then 8
decode steps teacher-forced on the reference's greedy tokens, each
step's logits and the final cache; and the greedy tokens of the port's
``serve_loop`` on the CPU against the reference's greedy loop on the
same weights and prompts.

Tolerance: max|diff| <= 1e-4 * max|ref| in f32 compute, as in
tests/test_torch_model.py: both sides run the same f32 arithmetic in
another summation order (the reference's chunked scan pads the
80-token prompt to 96 in chunks of 32; the port's masks the ragged
last chunk).

Two facts of the random-weight reference that the port shares are
pinned beside them: rounding is amplified with depth, and so is the
gradient norm (why full-depth zamba2 cannot train from random weights).
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
from repro_torch.launch.serve import serve_loop
from repro_torch.models import build
from repro_torch.models.convert import from_numpy
from repro_torch.models.params import leaves

TOL = 1e-4
DECODE_STEPS = 8

# zamba2's real SSM and attention head shapes at narrow width
HEAD_SHAPES = dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=80, d_ff=512,
                   vocab=256, ssm_state=64, ssm_head_dim=64, attn_every=2,
                   param_dtype="float32", compute_dtype="float32")

# name -> (config overrides or None for reduced(), prompt length)
CONFIGS = {
    "zamba2-2.7b-reduced": (None, 40),
    "zamba2-2.7b-head-shapes": (HEAD_SHAPES, 80),  # two 64-step chunks, the second ragged
}

# every registered kernel, none launched (the CPU runs the plain versions)
NO_LAUNCHES = {"dos_matmul": 0, "flash_attention": 0, "flash_attention_bwd": 0, "ssm_scan": 0,
               "ssm_scan_bwd": 0, "slstm_scan": 0, "slstm_scan_bwd": 0, "grouped_matmul": 0,
               "grouped_matmul_dw": 0, "decode_attention": 0, "adamw": 0}


def _cfgs(name):
    over, _ = CONFIGS[name]
    if over is None:
        return jax_reduced(jax_get_config("zamba2-2.7b")), reduced(get_config("zamba2-2.7b"))
    return (dataclasses.replace(jax_get_config("zamba2-2.7b"), **over),
            dataclasses.replace(get_config("zamba2-2.7b"), **over))


def _randomize(tree, rng):
    """Random norm scales, D and dt_bias (their init is ones and zeros)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("ln1", "ln2", "final_norm", "norm", "D"):
            out[k] = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(v.dtype)
        elif k == "dt_bias":
            out[k] = (-2.0 + 0.5 * rng.normal(size=v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _ref_cache(jcache):
    """The reference's cache tree mapped onto the port's layout."""
    j = jax.tree.map(np.asarray, jcache)
    return {"mamba": {"ssm": j["mamba"]["ssm"], "conv": j["mamba"]["conv"]},
            "attn": {"k": j["attn"]["k"], "v": j["attn"]["v"]},
            "length": int(j["attn"]["length"][0])}


def _snapshot(cache):
    """A copy: the port's decode writes its cache in place."""
    return {"mamba": {k: t.clone() for k, t in cache["mamba"].items()},
            "attn": {k: t.clone() for k, t in cache["attn"].items()},
            "length": cache["length"]}


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request):
    jcfg, cfg = _cfgs(request.param)
    prompt_len = CONFIGS[request.param][1]
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
        "params": (params_np, params),
        "prefill": (np.asarray(jl), tl.numpy()),
        "cache": (_ref_cache(jcache), _snapshot(tcache)),
        "steps": [],
    }
    jdecode = jax.jit(jmodel.decode)
    tok = np.asarray(jl)[:, -1:].argmax(-1)
    for _ in range(DECODE_STEPS):
        jl, jcache = jdecode(jparams, jcache, {"token": jnp.asarray(tok, jnp.int32)})
        tl, tcache = model.decode(params, tcache, {"token": torch.from_numpy(tok)})
        out["steps"].append((np.asarray(jl), tl.numpy()))
        tok = np.asarray(jl).argmax(-1)  # teacher-forced on the reference
    out["final_cache"] = (_ref_cache(jcache), tcache)
    return out


def _close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def _close_cache(got, ref):
    assert got["length"] == ref["length"]
    for group in ("mamba", "attn"):
        assert set(got[group]) == set(ref[group]) - {"length"}
        for name, t in got[group].items():
            _close(t, ref[group][name])


def test_weight_bridge_takes_the_hybrid_tree(run):
    """Every leaf (nested (n_groups, period, ...) stacks, shared_attn)
    crosses unchanged, f32 in f32 out."""
    params_np, params = run["params"]
    want = dict(leaves(params_np))
    got = dict(leaves(params))
    assert want.keys() == got.keys()
    assert any(p[0] == "shared_attn" for p in got)
    for path, t in got.items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), want[path])


def test_prefill_logits(run):
    ref, got = run["prefill"]
    assert got.dtype == np.float32
    _close(got, ref)


def test_prefill_cache(run):
    ref, got = run["cache"]
    _close_cache(got, ref)


def test_decode_logits_and_cache(run):
    for ref, got in run["steps"]:
        _close(got, ref)
    ref, got = run["final_cache"]
    _close_cache(got, ref)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_serve_loop_greedy_tokens_match_reference(name):
    """``serve_loop`` on the CPU draws its weights and prompts from the
    seed; the same weights and prompts through the reference's greedy
    loop (jit prefill, then argmax/decode steps) give the same tokens."""
    jcfg, cfg = _cfgs(name)
    batch, prompt_len, gen_tokens, seed = 2, 24, 6, 3
    got = serve_loop(cfg, batch=batch, prompt_len=prompt_len, gen_tokens=gen_tokens,
                     seed=seed, device="cpu")
    assert got["launches"]["prefill"] == NO_LAUNCHES

    model = build(cfg, device="cpu")
    params = model.compute_params(model.init(torch.Generator().manual_seed(seed)))
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(seed + 1))
    jmodel = jax_build(jcfg)
    jparams = jax.tree.map(jnp.asarray, _to_numpy(params))
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


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_from_empty_cache_and_param_count(name):
    """``init_cache`` + decode from an empty cache, and ``n_params``,
    against the reference's."""
    jcfg, cfg = _cfgs(name)
    jmodel, model = jax_build(jcfg), build(cfg, device="cpu")
    assert model.n_params == jmodel.n_params
    params_np = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    params = from_numpy(model, params_np)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jcache = jmodel.init_cache(2, 6, jnp.float32)
    tcache = model.init_cache(2, 6, torch.float32)
    _close_cache(tcache, _ref_cache(jcache))
    jdecode = jax.jit(jmodel.decode)
    for tok in np.random.default_rng(2).integers(0, cfg.vocab, (4, 2, 1)):
        jl, jcache = jdecode(jparams, jcache, {"token": jnp.asarray(tok, jnp.int32)})
        tl, tcache = model.decode(params, tcache, {"token": torch.from_numpy(tok)})
        _close(tl, np.asarray(jl))
    _close_cache(tcache, _ref_cache(jcache))


def test_full_zamba2_parameter_count():
    assert build(get_config("zamba2-2.7b"), device="cpu").n_params == \
        jax_build(jax_get_config("zamba2-2.7b")).n_params == 2_422_220_960


def test_random_weight_hybrid_amplifies_rounding_in_both_packages():
    """Why chip_smoke.py holds zamba2's bf16 path against the CPU block by
    block and not end to end: with random weights the hybrid amplifies
    rounding differences through its Mamba2 layers, in the reference as
    in the port. At 12 layers (2 groups, d_model 128) each package's
    bf16 and f32 logits differ by O(1) of their scale; at 6 layers (one
    group) by a few percent."""
    small = dict(d_model=128, d_ff=256, vocab=256, n_heads=4, n_kv_heads=4, head_dim=32)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 128))
    gap = {}
    for n_layers in (6, 12):
        jl, tl = {}, {}
        for dtype in ("bfloat16", "float32"):
            kw = dict(small, n_layers=n_layers, compute_dtype=dtype)
            jcfg = dataclasses.replace(jax_get_config("zamba2-2.7b"), **kw)
            cfg = dataclasses.replace(get_config("zamba2-2.7b"), **kw)
            jmodel, model = jax_build(jcfg), build(cfg, device="cpu")
            params_np = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
            params = model.compute_params(from_numpy(model, params_np))
            jparams = jax.tree.map(jnp.asarray, params_np)
            logits, _ = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}))(
                jparams, jnp.asarray(tokens, jnp.int32))
            jl[dtype] = np.asarray(logits, np.float32)
            tl[dtype] = model.prefill(params, {"tokens": torch.from_numpy(tokens)})[0].numpy()
        for name, out in (("reference", jl), ("port", tl)):
            ref = out["float32"]
            gap[name, n_layers] = np.abs(out["bfloat16"] - ref).max() / np.abs(ref).max()
    for name in ("reference", "port"):
        assert gap[name, 6] < 0.1, gap
        assert gap[name, 12] > 0.3, gap


def test_deep_random_hybrid_gradient_norm_explodes_in_both_packages():
    """A fact of the reference that the port shares: random-weight zamba2
    takes its residual stream into each Mamba2 layer without a norm, so
    the stream, and the gradient, grow with depth. At the reduced width,
    the global gradient norm AdamW clips with stays below 1e4 at 12
    layers and grows more than 1e8-fold by 54, in the JAX package and in
    the port alike (the two agree at 12 layers; at 54 the chaotic stream
    has taken their f32 rounding orders far apart). At zamba2's full
    width the f32 norm overflows, and the clip zeroes every update
    (chip_smoke.py phase 13)."""
    from repro.optim.adamw import global_norm as jax_global_norm
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.optim import global_norm

    norms = {}
    for layers in (12, 54):
        kw = dict(n_layers=layers, attn_every=6)
        jcfg = dataclasses.replace(jax_reduced(jax_get_config("zamba2-2.7b")), **kw)
        jmodel = jax_build(jcfg)
        model = build(dataclasses.replace(reduced(get_config("zamba2-2.7b")), **kw), device="cpu")
        rng = np.random.default_rng(0)
        params_np = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
        tokens = rng.integers(0, jcfg.vocab, (2, 64)).astype(np.int32)
        batch_np = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
        _, jg = jax.jit(jax.value_and_grad(jmodel.loss))(
            *(jax.tree.map(jnp.asarray, t) for t in (params_np, batch_np)))
        _, tg = loss_and_grads(model, from_numpy(model, params_np),
                               {k: torch.from_numpy(v) for k, v in batch_np.items()}, False)
        norms[layers] = (float(jax_global_norm(jg)), float(global_norm(tg)))
    (j12, t12), (j54, t54) = norms[12], norms[54]
    assert abs(t12 - j12) <= 1e-3 * j12 and j12 < 1e4, norms
    assert j54 > 1e8 * j12 and t54 > 1e8 * t12, norms


def test_full_size_hybrid_init_draws_the_reference_distribution_leaf_by_leaf():
    """Why full-depth zamba2's inf gradient norm (chip_smoke.py phase 13) is
    the reference's, not a fault of the port's init: at full width and
    depth the two packages define the same ParamDef tree (shape, axes,
    fan-in axis, init, scale) leaf by leaf, and each leaf's draw has the
    reference's distribution. Each leaf is drawn cut to about 2**20
    elements, keeping the axis its fan-in is read from (and the heads axis
    of ``neg_linspace``), so each package computes the full-size scale
    itself; the leading (stacking) axes change no element's distribution.
    Deterministic inits are equal; a normal init's mean lies within 6
    standard errors of 0 and its std within 6 standard errors of the
    full-size def's scale, in both packages."""
    from repro.models.params import ParamDef as JaxParamDef
    from repro.models.params import materialize as jax_materialize
    from repro_torch.models.params import materialize

    jdefs = jax_build(jax_get_config("zamba2-2.7b")).defs
    tdefs = dict(leaves(build(get_config("zamba2-2.7b"), device="cpu").defs))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jdefs, is_leaf=lambda x: isinstance(x, JaxParamDef))
    fields = ("shape", "axes", "contract", "out", "init", "scale")
    assert len(flat) == len(tdefs) == 23
    for i, (kpath, jd) in enumerate(flat):
        path = tuple(k.key for k in kpath)
        td = tdefs[path]
        assert [getattr(td, f) for f in fields] == [getattr(jd, f) for f in fields], path
        fan = jd.contract if jd.contract is not None else (0 if jd.scale is None else None)
        keep = {fan, len(jd.shape) - 1 if jd.init == "neg_linspace" else None} - {None}
        room = 2 ** 20 // int(np.prod([jd.shape[a] for a in keep], dtype=np.int64))
        shape = [1 if a not in keep else n for a, n in enumerate(jd.shape)]
        free = [a for a in range(len(shape)) if a not in keep]
        if free:
            shape[free[-1]] = max(1, min(jd.shape[free[-1]], room))
        want = np.asarray(jax_materialize({"x": dataclasses.replace(jd, shape=tuple(shape))},
                                          jax.random.PRNGKey(i))["x"])
        got = materialize({"x": dataclasses.replace(td, shape=tuple(shape))},
                          torch.Generator().manual_seed(i))["x"].numpy()
        assert got.shape == want.shape == tuple(shape) and got.dtype == want.dtype, path
        if jd.init != "normal":
            np.testing.assert_array_equal(got, want, err_msg=str(path))
            continue
        sigma = jd.scale if jd.scale is not None else 1 / np.sqrt(jd.shape[fan])
        n = got.size
        for x in (got, want):
            x = x.astype(np.float64)
            assert abs(x.mean()) <= 6 * sigma / np.sqrt(n), (path, x.mean(), sigma)
            assert abs(x.std() / sigma - 1) <= 6 / np.sqrt(2 * n), (path, x.std(), sigma)
