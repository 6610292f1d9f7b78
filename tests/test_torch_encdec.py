"""The port's encoder-decoder family (``models/encdec.py``: whisper) and
the layers it rests on (``attention`` without rope and bidirectional, its
cross path, the gelu ``mlp``) against the JAX package's, with the same
weights: the reference's parameters are exported through numpy and
loaded through the port's weight bridge, norm scales and MLP biases set
to random values first (their init is ones and zeros).

In f32 on the CPU, at ``reduced(whisper-medium)`` (2 encoder and 4
decoder layers, d_model 128, MHA 4/4, 64 frames, tied embeddings):
- ``_sinusoid``: XLA's f32 exp (the reference's) is not correctly
  rounded (on 11 % of whisper-medium's 512 frequencies it is 1 ulp off;
  torch's exp is off on 0.6 %), so each frequency is exact or 1 ulp from
  the reference's and the table within what 1 ulp of the frequency moves
  it: pos x ulp(freq), the angle's rounding and 1 ulp of the sine. A
  decode step's row (an offset) equals the prefill table's row at that
  position bit for bit;
- ``attention`` with ``theta=None`` (causal and not; prefill, train and
  decode), the gelu ``mlp`` (the tanh form, ``jax.nn.gelu``'s default) and
  ``encode`` within 1e-5 of max|ref|;
- the prefill logits and 4 teacher-forced decode steps within 1e-4 of
  max|ref|; a decode step against the prefill of one more token;
- ``Model.loss`` within 1e-5 and every gradient leaf within 1e-3 of the
  leaf's max|g| (remat off and on); accumulated microbatches against the
  whole batch;
- ``serve_loop`` on the CPU (no launches) against the reference's greedy
  loop on the same weights, prompts and frames;
- serving's init keeps ``lnx`` and ``enc_norm`` f32; the full-size
  parameter count.
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
from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro.models.params import materialize as jax_materialize
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import launch_counts
from repro_torch.launch.serve import model_inputs, serve_loop
from repro_torch.launch.steps import accumulate_grads, loss_and_grads, make_train_step
from repro_torch.models import build, encdec, layers
from repro_torch.models.convert import from_numpy
from repro_torch.models.params import leaves, map_tree
from repro_torch.optim import OptConfig, init_opt_state

ARCH = "whisper-medium"
BATCH, PROMPT, DECODE_STEPS = 2, 12, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


def _randomize(tree, rng):
    """Random norm scales and MLP biases (their init is ones and zeros)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("ln1", "ln2", "lnx", "final_norm", "enc_norm", "q_norm", "k_norm"):
            out[k] = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(v.dtype)
        elif k in ("bi", "bo"):
            out[k] = (0.1 * rng.normal(size=v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _torch(tree):
    return map_tree(lambda a: torch.tensor(np.asarray(a)), tree)


def _frames(cfg, batch=BATCH, seed=5):
    return np.random.default_rng(seed).normal(
        size=(batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))
    jmodel, model = jax_build(jcfg), build(cfg, device="cpu")
    params_np = _randomize(_np(jmodel.init(jax.random.PRNGKey(0))), np.random.default_rng(0))
    return jcfg, cfg, jmodel, model, params_np


# --- positions, layers, the encoder ------------------------------------------------


@pytest.mark.parametrize("seq,dim,offset", [(1500, 1024, 0), (64, 128, 0), (8, 128, 100),
                                            (1, 1024, 1537), (1, 6, 3)])
def test_sinusoid_matches_reference(seq, dim, offset):
    want = np.asarray(jax_encdec._sinusoid(seq, dim, offset))
    got = encdec._sinusoid(seq, dim, offset).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    half = dim // 2
    freq = np.exp(-np.arange(half) * (np.log(10_000.0) / max(half - 1, 1))).astype(np.float32)
    pos = (np.arange(seq) + offset).astype(np.float32)[:, None]
    freq = np.concatenate([freq, freq])[None]
    # the angle: one ulp of the frequency times pos, and its own rounding
    bound = pos * np.spacing(freq) + np.spacing(pos * freq) + np.spacing(np.float32(1))
    assert (np.abs(got - want) <= bound).all()


def test_sinusoid_offset_row_equals_the_table_row():
    table = encdec._sinusoid(40, 1024)
    for offset in (0, 1, 17, 39):
        assert torch.equal(encdec._sinusoid(1, 1024, offset)[0], table[offset])


def _attn_params(jcfg, seed=2):
    return _np(jax_materialize(jax_layers.attn_defs(jcfg), jax.random.PRNGKey(seed),
                               jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_attention_without_rope_matches_reference(setup, causal, mode):
    jcfg, cfg = setup[:2]
    p = _attn_params(jcfg)
    x = np.random.default_rng(3).normal(size=(BATCH, 23, cfg.d_model)).astype(np.float32)
    want, jc = jax_layers.attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
                                    mode=mode, theta=None, causal=causal)
    got, tc = layers.attention(_torch(p), torch.from_numpy(x), cfg, mode=mode, theta=None,
                               causal=causal)
    _close(got, want, 1e-5)
    if mode == "prefill":
        _close(tc["k"], jc["k"], 1e-5)
        _close(tc["v"], jc["v"], 1e-5)
        assert tc["length"] == int(jc["length"]) == 23


def test_decode_attention_without_rope_matches_reference(setup):
    jcfg, cfg = setup[:2]
    p = _attn_params(jcfg)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(BATCH, 1, cfg.d_model)).astype(np.float32)
    shape = (BATCH, 16, cfg.n_kv_heads, cfg.head_dim_)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    want, jc = jax_layers.attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg, mode="decode", theta=None,
        cache={"k": jnp.asarray(k), "v": jnp.asarray(v), "length": jnp.int32(9)})
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()), "length": 9}
    got, tc = layers.attention(_torch(p), torch.from_numpy(x), cfg, mode="decode", theta=None,
                               cache=cache)
    _close(got, want, 1e-5)
    _close(tc["k"], jc["k"], 1e-5)
    assert tc["length"] == 10


def test_gelu_mlp_matches_reference(setup):
    jcfg, cfg = setup[:2]
    defs = jax_layers.mlp_defs(jcfg)
    assert set(defs) == {"wi", "bi", "wo", "bo"}
    assert {k: d.shape for k, d in defs.items()} == {
        k: d.shape for k, d in layers.mlp_defs(cfg).items()}
    p = _randomize(_np(jax_materialize(defs, jax.random.PRNGKey(6), jnp.float32)),
                   np.random.default_rng(6))
    x = 3 * np.random.default_rng(7).normal(size=(BATCH, 17, cfg.d_model)).astype(np.float32)
    want = jax_layers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), "gelu")
    _close(layers.mlp(_torch(p), torch.from_numpy(x)), want, 1e-5)


def test_encode_matches_reference(setup):
    jcfg, cfg, _, model, params_np = setup
    frames = _frames(cfg)
    want = jax.jit(lambda p, f: jax_encdec.encode(p, f, jcfg))(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(frames))
    got = encdec.encode(from_numpy(model, params_np), torch.from_numpy(frames), cfg)
    _close(got, want, 1e-5)


# --- the model ------------------------------------------------------------------


@pytest.fixture(scope="module")
def run(setup):
    _, cfg, jmodel, model, params_np = setup
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (BATCH, PROMPT))
    frames = _frames(cfg)
    max_len = PROMPT + DECODE_STEPS + 1
    jparams = jax.tree.map(jnp.asarray, params_np)
    params = from_numpy(model, params_np)
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len=max_len))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32), "enc_frames": jnp.asarray(frames)})
    before = launch_counts()
    tl, tcache = model.prefill(params, {"tokens": torch.from_numpy(tokens),
                                        "enc_frames": torch.from_numpy(frames)}, max_len=max_len)
    # copies: the port's decode steps write into its cache in place
    out = {"prefill": (np.asarray(jl), tl), "steps": [],
           "cache": (_np(jcache), {k: map_tree(torch.clone, tcache[k]) for k in ("self", "cross")})}
    jdecode = jax.jit(jmodel.decode)
    tok = np.asarray(jl)[:, -1:].argmax(-1)
    for _ in range(DECODE_STEPS):
        jl, jcache = jdecode(jparams, jcache, {"token": jnp.asarray(tok, jnp.int32)})
        tl, tcache = model.decode(params, tcache, {"token": torch.from_numpy(tok)})
        out["steps"].append((np.asarray(jl), tl))
        tok = np.asarray(jl).argmax(-1)
    out["launches"] = (before, launch_counts())
    out["length"] = (tcache["length"], np.asarray(jcache["self"]["length"]))
    return out


def test_prefill_logits(run):
    want, got = run["prefill"]
    _close(got, want, 1e-4)


def test_prefill_cache(run, setup):
    cfg = setup[1]
    jcache, tcache = run["cache"]
    assert tuple(tcache["self"]["k"].shape) == (cfg.n_layers, BATCH, PROMPT + DECODE_STEPS + 1,
                                                cfg.n_kv_heads, cfg.head_dim_)
    assert tuple(tcache["cross"]["k"].shape) == (cfg.n_layers, BATCH, cfg.enc_seq,
                                                 cfg.n_kv_heads, cfg.head_dim_)
    for kind in ("self", "cross"):
        for kv in ("k", "v"):
            _close(tcache[kind][kv], jcache[kind][kv], 1e-5)


def test_decode_logits(run):
    length, jlength = run["length"]
    assert length == PROMPT + DECODE_STEPS and (jlength == length).all()  # one length, (L,) there
    for want, got in run["steps"]:
        _close(got, want, 1e-4)


def test_cpu_path_launches_no_kernel(run):
    before, after = run["launches"]
    assert before == after


def test_decode_matches_prefill_of_one_more_token(setup):
    _, cfg, _, model, params_np = setup
    params = from_numpy(model, params_np)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (BATCH, 13)))
    frames = torch.from_numpy(_frames(cfg))
    full, _ = model.prefill(params, {"tokens": toks, "enc_frames": frames}, max_len=14)
    _, cache = model.prefill(params, {"tokens": toks[:, :12], "enc_frames": frames}, max_len=14)
    got, _ = model.decode(params, cache, {"token": toks[:, 12:]})
    _close(got[:, 0], full[:, 12], 1e-5)


def test_decode_from_an_initial_cache_is_shaped_like_the_prefill_cache(setup):
    _, cfg, _, model, _ = setup
    cache = model.init_cache(BATCH, 20, torch.float32)
    assert cache["length"] == 0
    assert tuple(cache["self"]["k"].shape) == (cfg.n_layers, BATCH, 20, cfg.n_kv_heads,
                                               cfg.head_dim_)
    assert tuple(cache["cross"]["v"].shape) == (cfg.n_layers, BATCH, cfg.enc_seq,
                                                cfg.n_kv_heads, cfg.head_dim_)


@pytest.fixture(scope="module")
def grads(setup):
    _, cfg, jmodel, model, params_np = setup
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (BATCH, 20)).astype(np.int32)
    batch_np = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
                "enc_frames": _frames(cfg, seed=10)}
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
    assert ("enc_layers", "ffn", "bi") in jg and ("dec_layers", "xattn", "wk") in jg
    for path, want in jg.items():
        got = tg[path]
        assert got.shape == want.shape and np.isfinite(got).all(), path
        assert np.abs(want).max() > 0, path
        _close(got, want, 1e-3)


def test_microbatches_equal_the_whole_batch(setup, grads):
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
    assert not torch.equal(new["enc_norm"], params["enc_norm"])


# --- the loop, the init ------------------------------------------------------------


def test_serve_loop_on_the_cpu_matches_reference():
    """``serve_loop`` draws the weights, prompts and frames from the seed
    and launches nothing on the CPU; the reference's greedy loop on the
    same inputs gives the same tokens."""
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
    frames = model_inputs(cfg, batch, seed)["enc_frames"]
    assert tuple(frames.shape) == (batch, cfg.enc_seq, cfg.d_model)
    jmodel = jax_build(jcfg)
    jparams = jax.tree.map(jnp.asarray, map_tree(lambda t: t.numpy(), params))
    logits, cache = jax.jit(
        lambda p, b: jmodel.prefill(p, b, max_len=prompt_len + gen_tokens)
    )(jparams, {"tokens": jnp.asarray(prompts.numpy(), jnp.int32),
                "enc_frames": jnp.asarray(frames.numpy())})
    tok = jnp.argmax(logits[:, -1:], axis=-1)
    want = [tok]
    decode = jax.jit(jmodel.decode)
    for _ in range(gen_tokens - 1):
        logits, cache = decode(jparams, cache, {"token": tok})
        tok = jnp.argmax(logits, axis=-1)
        want.append(tok)
    np.testing.assert_array_equal(got["generated"].numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))


def test_serving_init_keeps_the_norms_f32():
    cfg = dataclasses.replace(reduced(get_config(ARCH)), compute_dtype="bfloat16")
    model = build(cfg, device="cpu")
    want = model.compute_params(model.init(torch.Generator().manual_seed(7)))
    got = model.init_compute(torch.Generator().manual_seed(7))
    for (path, w), (_, g) in zip(leaves(want), leaves(got)):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    assert got["enc_norm"].dtype == torch.float32
    assert got["dec_layers"]["lnx"].dtype == torch.float32
    assert got["dec_layers"]["ffn"]["bi"].dtype == torch.bfloat16


def test_full_size_parameter_count():
    assert build(get_config(ARCH), device="cpu").n_params == 758_123_520
