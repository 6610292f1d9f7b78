"""The port's vision cross-attention family (the decoder's ``vlm`` branch,
``layers.compute_cross_kv`` and the cross path of ``layers.attention``)
against the JAX package's, with the same weights: the reference's
parameters are exported through numpy and loaded through the port's
weight bridge.

The cross layers' ``gate`` starts at zero, and the cross output is
multiplied by tanh(gate): at init no cross-attention result reaches the
logits, so a check on the init would pass with a broken cross path. Every
parity check here sets the gates to 0.5 on both sides (and the norm
scales and biases to random values); one test shows that a zero gate
hides the image in both packages.

In f32 on the CPU, at ``reduced(llama-3.2-vision-11b)`` (4 layers: 2
groups of 1 self-attention layer and 1 cross layer, d_model 128, GQA 4/1,
16 image tokens):
- ``compute_cross_kv`` and the cross path of ``attention`` (prefill and
  decode, with and without ``qk_norm``) within 1e-5 of max|ref|;
- the prefill logits and 4 teacher-forced decode steps within 1e-4 of
  max|ref|; a decode step against the prefill of one more token;
- ``Model.loss`` within 1e-5 and every gradient leaf within 1e-3 of the
  leaf's max|g| (remat off and on); accumulated microbatches against the
  whole batch;
- ``serve_loop`` on the CPU (no launches) and ``generate`` with open
  gates against the reference's greedy loop on the same weights, prompts
  and image embeddings;
- bf16 compute with f32 image embeddings: the reference projects the
  cross k, v in f32 (``proj`` casts the weight to the source's dtype) and
  its attention returns q's dtype, so the residual stream stays bf16 and
  only the cross cache is f32; the port's CPU path does the same (on the
  card the flash kernel refuses mixed operands: tests/test_torch_cuda.py);
- the weight bridge, serving's init (``gate`` kept f32) and the depth cut.
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
from repro.models import layers as jax_layers
from repro.models.params import materialize as jax_materialize
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import launch_counts
from repro_torch.launch import train
from repro_torch.launch.serve import generate, model_inputs, serve_loop
from repro_torch.launch.steps import accumulate_grads, loss_and_grads, make_train_step
from repro_torch.models import build, layers
from repro_torch.models.convert import from_numpy
from repro_torch.models.params import leaves, map_tree
from repro_torch.optim import OptConfig, init_opt_state

ARCH = "llama-3.2-vision-11b"
BATCH, PROMPT, DECODE_STEPS = 2, 12, 4
GATE = 0.5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


def _randomize(tree, rng, gate=GATE):
    """Random norm scales (their init is ones), and every cross layer's
    gate set to ``gate``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, gate)
        elif k in ("ln1", "ln2", "final_norm", "q_norm", "k_norm"):
            out[k] = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(v.dtype)
        elif k == "gate":
            out[k] = np.full(v.shape, gate, v.dtype)
        else:
            out[k] = v
    return out


def _image(cfg, batch=BATCH, seed=5):
    return np.random.default_rng(seed).normal(
        size=(batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))
    jmodel, model = jax_build(jcfg), build(cfg, device="cpu")
    params_np = _randomize(_np(jmodel.init(jax.random.PRNGKey(0))), np.random.default_rng(0))
    return jcfg, cfg, jmodel, model, params_np


# --- the layers -----------------------------------------------------------------


def _torch(tree):
    return map_tree(lambda a: torch.tensor(np.asarray(a)), tree)


def test_compute_cross_kv_matches_reference(setup):
    jcfg, cfg, _, _, params_np = setup
    p = jax.tree.map(lambda a: a[1], params_np["cross_layers"]["attn"])
    img = _image(cfg)
    jk, jv = jax_layers.compute_cross_kv(jax.tree.map(jnp.asarray, p), jnp.asarray(img), jcfg)
    tk, tv = layers.compute_cross_kv(_torch(p), torch.from_numpy(img), cfg)
    assert tuple(tk.shape) == (BATCH, cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim_)
    _close(tk, jk, 1e-5)
    _close(tv, jv, 1e-5)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("mode,s", [("prefill", 9), ("train", 9), ("decode", 1)])
def test_cross_attention_matches_reference(setup, qk_norm, mode, s):
    """The cross path: every image token visible, q normed if qk_norm and
    k not, no cache returned."""
    jcfg, cfg = (dataclasses.replace(c, qk_norm=qk_norm) for c in setup[:2])
    p = _randomize(_np(jax_materialize(jax_layers.attn_defs(jcfg), jax.random.PRNGKey(2),
                                       jnp.float32)), np.random.default_rng(2))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(BATCH, s, cfg.d_model)).astype(np.float32)
    img = _image(cfg)
    jp = jax.tree.map(jnp.asarray, p)
    jkv = jax_layers.compute_cross_kv(jp, jnp.asarray(img), jcfg)
    want, jc = jax_layers.attention(jp, jnp.asarray(x), jcfg, mode=mode, cross_kv=jkv)
    tp = _torch(p)
    tkv = layers.compute_cross_kv(tp, torch.from_numpy(img), cfg)
    got, tc = layers.attention(tp, torch.from_numpy(x), cfg, mode=mode, cross_kv=tkv)
    assert jc is None and tc is None
    _close(got, want, 1e-5)


# --- the model ------------------------------------------------------------------


def _prefill_decode(jmodel, model, params_np, tokens, img, steps=DECODE_STEPS):
    """Both packages' prefill of ``tokens`` with ``img``, then ``steps``
    decode steps teacher-forced on the reference's greedy tokens."""
    max_len = tokens.shape[1] + steps + 1
    jparams = jax.tree.map(jnp.asarray, params_np)
    params = from_numpy(model, params_np)
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len=max_len))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32), "image_embeds": jnp.asarray(img)})
    before = launch_counts()
    tl, tcache = model.prefill(params, {"tokens": torch.from_numpy(tokens),
                                        "image_embeds": torch.from_numpy(img)}, max_len=max_len)
    # copies: the port's decode steps write into its cache in place
    out = {"prefill": (np.asarray(jl), tl), "steps": [],
           "cache": (_np(jcache),
                     {k: map_tree(torch.clone, tcache[k]) for k in ("layers", "cross")})}
    jdecode = jax.jit(jmodel.decode)
    tok = np.asarray(jl)[:, -1:].argmax(-1)
    for _ in range(steps):
        jl, jcache = jdecode(jparams, jcache, {"token": jnp.asarray(tok, jnp.int32)})
        tl, tcache = model.decode(params, tcache, {"token": torch.from_numpy(tok)})
        out["steps"].append((np.asarray(jl), tl))
        tok = np.asarray(jl).argmax(-1)
    out["launches"] = (before, launch_counts())
    out["length"] = tcache["length"]
    return out


@pytest.fixture(scope="module")
def run(setup):
    _, cfg, jmodel, model, params_np = setup
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (BATCH, PROMPT))
    return _prefill_decode(jmodel, model, params_np, tokens, _image(cfg))


def test_prefill_logits(run):
    want, got = run["prefill"]
    _close(got, want, 1e-4)


def test_prefill_cache(run, setup):
    cfg = setup[1]
    jcache, tcache = run["cache"]
    n_groups, n_self = cfg.n_layers // cfg.cross_every, cfg.cross_every - 1
    assert tuple(tcache["cross"]["k"].shape) == (n_groups, BATCH, cfg.n_image_tokens,
                                                 cfg.n_kv_heads, cfg.head_dim_)
    assert tuple(tcache["layers"]["k"].shape[:2]) == (n_groups, n_self)
    empty = setup[3].init_cache(BATCH, PROMPT + DECODE_STEPS + 1, torch.float32)
    for kind in ("cross", "layers"):
        for kv in ("k", "v"):
            _close(tcache[kind][kv], jcache[kind][kv], 1e-5)
            assert empty[kind][kv].shape == tcache[kind][kv].shape and not empty[kind][kv].any()
    assert empty["length"] == 0


def test_decode_logits(run):
    assert run["length"] == PROMPT + DECODE_STEPS
    for want, got in run["steps"]:
        _close(got, want, 1e-4)


def test_cpu_path_launches_no_kernel(run):
    before, after = run["launches"]
    assert before == after


def test_decode_matches_prefill_of_one_more_token(setup):
    """decode(token S) == prefill(S+1)[S] (the reference's
    test_decode_matches_prefill), with open gates."""
    _, cfg, _, model, params_np = setup
    params = from_numpy(model, params_np)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (BATCH, 13)))
    img = torch.from_numpy(_image(cfg))
    full, _ = model.prefill(params, {"tokens": toks, "image_embeds": img}, max_len=14)
    _, cache = model.prefill(params, {"tokens": toks[:, :12], "image_embeds": img}, max_len=14)
    got, _ = model.decode(params, cache, {"token": toks[:, 12:]})
    _close(got[:, 0], full[:, 12], 1e-5)


def test_zero_gate_hides_the_cross_path_in_both_packages(setup):
    """At the init's gate 0 two different images give the same logits, bit
    for bit, in the reference and in the port; at gate 0.5 they do not."""
    _, cfg, jmodel, model, params_np = setup
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (BATCH, PROMPT))
    img_a, img_b = _image(cfg, seed=8), _image(cfg, seed=9)
    for gate in (0.0, GATE):
        p = _randomize(params_np, np.random.default_rng(0), gate)
        jparams, params = jax.tree.map(jnp.asarray, p), from_numpy(model, p)
        jl = [np.asarray(jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                                                  "image_embeds": jnp.asarray(img)})[0])
              for img in (img_a, img_b)]
        tl = [model.prefill(params, {"tokens": torch.from_numpy(tokens),
                                     "image_embeds": torch.from_numpy(img)})[0].numpy()
              for img in (img_a, img_b)]
        for a, b in (jl, tl):
            if gate == 0.0:
                np.testing.assert_array_equal(a, b)
            else:
                assert np.abs(a - b).max() > 1e-2 * np.abs(a).max()


@pytest.fixture(scope="module")
def grads(setup):
    _, cfg, jmodel, model, params_np = setup
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (BATCH, 20)).astype(np.int32)
    batch_np = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
                "image_embeds": _image(cfg, seed=10)}
    jl, jg = jax.jit(jax.value_and_grad(jmodel.loss))(jax.tree.map(jnp.asarray, params_np),
                                                      jax.tree.map(jnp.asarray, batch_np))
    jg = {p: np.asarray(g) for p, g in leaves(_np(jg))}
    out = {}
    for remat in (False, True):
        tl, tg = loss_and_grads(model, from_numpy(model, params_np),
                                {k: torch.from_numpy(v) for k, v in batch_np.items()}, remat)
        out[remat] = (float(tl), {p: g.numpy() for p, g in leaves(tg)})
    return float(jl), jg, out, batch_np


@pytest.mark.parametrize("remat", [False, True])
def test_loss_matches_reference(grads, remat):
    jl, _, out, _ = grads
    tl, _ = out[remat]
    assert np.isfinite(tl)
    assert abs(tl - jl) <= 1e-5 * abs(jl)


@pytest.mark.parametrize("remat", [False, True])
def test_every_gradient_leaf_matches_reference(grads, remat):
    _, jg, out, _ = grads
    _, tg = out[remat]
    assert jg.keys() == tg.keys()
    assert ("cross_layers", "gate") in jg
    for path, want in jg.items():
        got = tg[path]
        assert got.shape == want.shape and np.isfinite(got).all(), path
        assert np.abs(want).max() > 0, path  # open gates: the gradient reaches every leaf
        _close(got, want, 1e-3)


def test_microbatches_equal_the_whole_batch(setup, grads):
    """Two accumulated microbatches (the split slices image_embeds with the
    tokens) give the whole batch's loss and gradients; a microbatched
    train step runs on such a batch."""
    _, _, _, model, params_np = setup
    batch = {k: torch.from_numpy(v) for k, v in grads[3].items()}
    params = from_numpy(model, params_np)
    loss, g = loss_and_grads(model, params, batch, True)
    loss2, g2 = accumulate_grads(model, params, batch, True, 2)
    assert abs(float(loss2) - float(loss)) <= 1e-6 * abs(float(loss))
    for (path, a), (_, b) in zip(leaves(g), leaves(g2)):
        _close(b, a, 1e-5)
    step = make_train_step(model, OptConfig(lr=1e-3), microbatches=2)
    new, _, l3 = step(map_tree(torch.clone, params), init_opt_state(params), batch)
    assert abs(float(l3) - float(loss)) <= 1e-6 * abs(float(loss))
    assert not torch.equal(new["cross_layers"]["gate"], params["cross_layers"]["gate"])


# --- the loops -------------------------------------------------------------------


def _reference_greedy(jmodel, params, prompts, inputs, gen_tokens):
    jparams = jax.tree.map(jnp.asarray, map_tree(lambda t: t.float().numpy(), params))
    batch = {"tokens": jnp.asarray(prompts.numpy(), jnp.int32),
             **{k: jnp.asarray(t.float().numpy()) for k, t in inputs.items()}}
    logits, cache = jax.jit(
        lambda p, b: jmodel.prefill(p, b, max_len=prompts.shape[1] + gen_tokens))(jparams, batch)
    tok = jnp.argmax(logits[:, -1:], axis=-1)
    want = [tok]
    decode = jax.jit(jmodel.decode)
    for _ in range(gen_tokens - 1):
        logits, cache = decode(jparams, cache, {"token": tok})
        tok = jnp.argmax(logits, axis=-1)
        want.append(tok)
    return np.asarray(jnp.concatenate(want, axis=1))


def test_serve_loop_on_the_cpu_matches_reference():
    """``serve_loop`` draws the weights, prompts and image embeddings from
    the seed and launches nothing on the CPU; the reference's greedy loop
    on the same inputs gives the same tokens."""
    jcfg, cfg = jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))
    batch, prompt_len, gen_tokens, seed = 2, 10, 5, 3
    got = serve_loop(cfg, batch=batch, prompt_len=prompt_len, gen_tokens=gen_tokens, seed=seed,
                     device="cpu")
    assert tuple(got["generated"].shape) == (batch, gen_tokens)
    assert not any(got["launches"]["prefill"].values())
    assert not any(got["launches"]["decode"].values())
    model = build(cfg, device="cpu")
    params = model.compute_params(model.init(torch.Generator().manual_seed(seed)))
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(seed + 1))
    inputs = model_inputs(cfg, batch, seed)
    assert tuple(inputs["image_embeds"].shape) == (batch, cfg.n_image_tokens, cfg.d_model)
    want = _reference_greedy(jax_build(jcfg), params, prompts, inputs, gen_tokens)
    np.testing.assert_array_equal(got["generated"].numpy(), want)


def test_generate_with_open_gates_matches_reference(setup):
    _, cfg, jmodel, model, params_np = setup
    params = from_numpy(model, params_np)
    prompts = torch.from_numpy(np.random.default_rng(11).integers(0, cfg.vocab, (BATCH, 10)))
    inputs = {"image_embeds": torch.from_numpy(_image(cfg, seed=12))}
    got = generate(model, params, prompts, 6, inputs)
    want = _reference_greedy(jmodel, params, prompts, inputs, 6)
    np.testing.assert_array_equal(got["generated"].numpy(), want)


# --- dtypes, the bridge, the init, the depth cut -----------------------------------


@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
def test_bf16_compute_keeps_the_image_dtype_in_the_cross_cache_only(setup, image_dtype):
    """bf16 compute: the cross k, v (and their cache) take the image
    embeddings' dtype; the self cache, and so the residual stream, stay
    bf16, in both packages; the logits agree within the bf16 band (3e-2)."""
    jcfg, cfg, _, _, params_np = setup
    jcfg, cfg = (dataclasses.replace(c, compute_dtype="bfloat16") for c in (jcfg, cfg))
    jmodel, model = jax_build(jcfg), build(cfg, device="cpu")
    img = torch.from_numpy(_image(cfg)).to(getattr(torch, image_dtype))
    tokens = np.random.default_rng(13).integers(0, cfg.vocab, (BATCH, PROMPT))
    jl, jc = jmodel.prefill(jax.tree.map(jnp.asarray, params_np),
                            {"tokens": jnp.asarray(tokens, jnp.int32),
                             "image_embeds": jnp.asarray(img.float().numpy()).astype(
                                 jnp.dtype(image_dtype))}, max_len=PROMPT + 2)
    params = model.compute_params(from_numpy(model, params_np))
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(tokens), "image_embeds": img},
                           max_len=PROMPT + 2)
    # the second group's self layer projects its k from the stream after the
    # first cross layer: a stream promoted to f32 would show in its k
    assert tc["cross"]["k"].dtype == getattr(torch, image_dtype)
    assert str(jc["cross"]["k"].dtype) == image_dtype
    assert tc["layers"]["k"].dtype == torch.bfloat16 and jc["layers"]["k"].dtype == jnp.bfloat16
    assert tl.dtype == torch.float32
    _close(tl, np.asarray(jl), 3e-2)


def test_weight_bridge_takes_the_nested_tree(setup):
    _, cfg, _, model, params_np = setup
    params = from_numpy(model, params_np)
    n_groups, n_self = cfg.n_layers // cfg.cross_every, cfg.cross_every - 1
    assert tuple(params["layers"]["attn"]["wq"].shape[:2]) == (n_groups, n_self)
    assert tuple(params["cross_layers"]["gate"].shape) == (n_groups, 1)
    for path, a in leaves(params_np):
        np.testing.assert_array_equal(dict(leaves(params))[path].numpy(), a)
    with pytest.raises(ValueError, match="cross_layers"):
        from_numpy(model, {k: v for k, v in params_np.items() if k != "cross_layers"})


def test_serving_init_keeps_the_gate_f32():
    cfg = dataclasses.replace(reduced(get_config(ARCH)), compute_dtype="bfloat16")
    model = build(cfg, device="cpu")
    want = model.compute_params(model.init(torch.Generator().manual_seed(7)))
    got = model.init_compute(torch.Generator().manual_seed(7))
    for (path, w), (_, g) in zip(leaves(want), leaves(got)):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    assert got["cross_layers"]["gate"].dtype == torch.float32
    assert got["cross_layers"]["attn"]["wq"].dtype == torch.bfloat16


def test_depth_cut_keeps_whole_groups():
    cfg = get_config(ARCH)
    assert train.cut_depth(cfg, 5).n_layers == 5
    for n in (3, 4, 6):
        with pytest.raises(ValueError, match="multiple of cross_every"):
            train.cut_depth(cfg, n)
    with pytest.raises(ValueError, match="multiple of cross_every"):
        train.main(["--arch", ARCH, "--smoke", "--layers", "3", "--device", "cpu"])


def test_full_size_parameter_count():
    assert build(get_config(ARCH), device="cpu").n_params == 9_775_157_256
