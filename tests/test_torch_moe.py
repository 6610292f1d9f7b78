"""The port's MoE family (``models/moe.py``, the decoder's ``moe`` branch,
``kernels/grouped_matmul``) against the JAX package's, with the same
weights: the reference's parameters are exported through numpy and
loaded through the port's weight bridge, norm scales set to random
values first (their init is ones).

In f32 on the CPU, at ``reduced(deepseek-moe-16b)`` (8 experts, top-2, 1
shared expert) and ``reduced(llama4-scout)`` (8 experts, top-1, 1
shared), d_model 128, expert d_ff 64, 4 layers:
- the plain grouped GEMM against ``jax.lax.ragged_dot`` (empty groups, a
  group that holds every row, rows past the sum), within 1e-6 of max|ref|
  (f32 sums in another order); its closed-form backward against torch
  autograd of the loop and ``jax.grad`` of ``ragged_dot``, and the
  wrapper's autograd Function on the CPU against the same;
- routing: the top-k indices equal the reference's ``lax.top_k`` on the
  same input at every route call of ``moe_block``, the prefill, the
  decode steps and the training step (each test prints the smallest k-th
  to (k+1)-th probability gap it saw, so a near-tie flip would show as a
  routing difference), exact ties to the lower index;
- ``moe_block`` within 1e-5 of max|ref|; ``aux_load_balance_loss`` within
  1e-6; the prefill logits and 6 teacher-forced decode steps within 1e-4
  of max|ref|;
- ``Model.loss`` (the load-balance term included) within 1e-5 and every
  gradient leaf within 1e-3 of the leaf's max|g|, remat off and on. One
  leaf differs: with top-1 routing the renormalised weight p / p is 1
  and its derivative 0, so the router's gradient is the load-balance
  term's alone (layer 0), and the port computes that 0 exactly; the
  reference's autodiff leaves rounding noise there, 1.5-1.8e-3 of the
  leaf's max|g|. So the top-1 router leaf is held to ``jax.grad`` of the
  reference's load-balance term, within 1e-5 of its max|g|, and to the
  reference's ``Model.loss`` gradient within 5e-3;
- ``serve_loop``'s greedy tokens against the reference's loop on the same
  weights; ``train_loop`` with a fault and a resume that repeats the
  uninterrupted run bit for bit; the train CLI's ``--layers``;
- ``Model.init_compute`` (serving's init, a leaf at a time) bit-identical
  to ``compute_params(init(...))`` for a reduced config of each ported
  family, in f32 and bf16 compute; the router stays f32.
"""

import dataclasses
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
from repro.models import moe as jax_moe
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import grouped_matmul, launch_counts
from repro_torch.kernels.grouped_matmul import grouped_matmul_dw_ref, grouped_matmul_ref
from repro_torch.launch.serve import serve_loop
from repro_torch.launch.steps import loss_and_grads
from repro_torch.launch.train import train_loop
from repro_torch.models import build, moe
from repro_torch.models.convert import from_numpy
from repro_torch.models.params import leaves, map_tree
from repro_torch.runtime import FaultInjector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e"]
TOL = 1e-4
DECODE_STEPS = 6
PROMPT = 24
BATCH = 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


# --- the grouped GEMM ---------------------------------------------------------

GROUP_CASES = {
    "random": [5, 0, 9, 3, 0, 7],
    "empty groups": [0, 0, 12, 0, 12, 0],
    "one group holds every row": [0, 24, 0, 0],
    "rows past the sum": [3, 0, 5, 2],  # 10 of 24 rows
    "one group": [24],
}


def _gmm_case(name, k=40, n=24, seed=0):
    sizes = np.asarray(GROUP_CASES[name], np.int32)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(24, k)).astype(np.float32)
    w = rng.normal(size=(len(sizes), k, n)).astype(np.float32)
    dy = rng.normal(size=(24, n)).astype(np.float32)
    return x, w, sizes, dy


@pytest.mark.parametrize("name", list(GROUP_CASES))
def test_plain_grouped_matmul_matches_ragged_dot(name):
    x, w, sizes, _ = _gmm_case(name)
    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes)))
    got = grouped_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sizes))
    _close(got, want, 1e-6)
    past = int(sizes.sum())
    assert not got[past:].any()  # rows past the sum are zero, as in ragged_dot


def _loop_autograd(x, w, sizes, dy):
    """torch autograd of the plain per-group loop."""
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out, off = [], 0
    for g, s in enumerate(sizes.tolist()):
        out.append(xt[off:off + s] @ wt[g])
        off += s
    out.append(torch.zeros(len(x) - off, w.shape[-1]))
    torch.cat(out).backward(torch.from_numpy(dy))
    return xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("name", list(GROUP_CASES))
def test_closed_form_backward_matches_autograd_and_jax(name):
    x, w, sizes, dy = _gmm_case(name)
    xt, wt, st, dyt = map(torch.from_numpy, (x, w, sizes, dy))
    dx = grouped_matmul_ref(dyt, wt.transpose(-1, -2), st)
    dw = grouped_matmul_dw_ref(xt, dyt, st)
    ax, aw = _loop_autograd(x, w, sizes, dy)
    _, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, jnp.asarray(sizes)),
                     jnp.asarray(x), jnp.asarray(w))
    jx, jw = vjp(jnp.asarray(dy))
    for got, want in ((dx, ax), (dw, aw), (dx, jx), (dw, jw)):
        _close(got, want, 1e-6)
    for g, s in enumerate(sizes):
        if s == 0:
            assert not dw[g].any()  # an empty group's gradient is zero

    # the wrapper's autograd Function (on the CPU: the plain versions)
    xg, wg = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    before = launch_counts()
    out = grouped_matmul(xg, wg, st)
    out.backward(dyt)
    assert launch_counts() == before
    _close(out, grouped_matmul_ref(xt, wt, st), 0)
    _close(xg.grad, ax, 1e-6)
    _close(wg.grad, aw, 1e-6)


@pytest.mark.parametrize("name", list(GROUP_CASES))
def test_f32_output_of_bf16_operands(name):
    """A mesh's K-split and row-parallel expert partials: the bf16
    operands' f32 sums, unrounded (``out_dtype=torch.float32``), equal
    ``ragged_dot`` with ``preferred_element_type=float32`` within 1e-6 of
    max|ref|; rounded once, the bf16 output; and through the autograd
    Function the f32 output's gradient reaches x and w in their dtype,
    as the bf16 output's does."""
    x, w, sizes, dy = _gmm_case(name)
    xt, wt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    st, dyt = torch.from_numpy(sizes), torch.from_numpy(dy)
    got = grouped_matmul(xt, wt, st, out_dtype=torch.float32)
    want = jax.lax.ragged_dot(jnp.asarray(xt.float().numpy(), jnp.bfloat16),
                              jnp.asarray(wt.float().numpy(), jnp.bfloat16), jnp.asarray(sizes),
                              preferred_element_type=jnp.float32)
    assert got.dtype == torch.float32
    _close(got, np.asarray(want), 1e-6)
    assert torch.equal(got.to(torch.bfloat16), grouped_matmul(xt, wt, st))
    grads = []
    for out_dtype in (torch.float32, None):
        xg, wg = xt.clone().requires_grad_(), wt.clone().requires_grad_()
        grouped_matmul(xg, wg, st, out_dtype=out_dtype).backward(dyt.to(out_dtype or xt.dtype))
        assert xg.grad.dtype == wg.grad.dtype == torch.bfloat16
        grads.append((xg.grad, wg.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# --- the model ---------------------------------------------------------------


def _randomize(tree, rng):
    """Random norm scales (their init is ones)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("ln1", "ln2", "final_norm"):
            out[k] = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    jmodel, model = jax_build(jcfg), build(cfg, device="cpu")
    params_np = _randomize(_np(jmodel.init(jax.random.PRNGKey(0))), np.random.default_rng(0))
    return jcfg, cfg, jmodel, model, params_np


def _layer_ffn(params_np, i):
    return jax.tree.map(lambda a: a[i], params_np["layers"]["ffn"])


def _routing_agrees(jcfg, cfg, ffn_np, xt):
    """The port's routing of ``xt`` against ``lax.top_k`` of the
    reference's probabilities: indices equal, weights within 1e-6.
    Returns the smallest k-th to (k+1)-th probability gap."""
    k = cfg.top_k
    logits = jax_moe.proj(jnp.asarray(xt), jnp.asarray(ffn_np["router"]))
    probs = jax.nn.softmax(logits, axis=-1)
    jp, ji = jax.lax.top_k(probs, k)
    jp = jp / jnp.sum(jp, axis=-1, keepdims=True)
    tp, ti = moe.route(map_tree(torch.tensor, ffn_np), torch.from_numpy(xt), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tp, jp, 1e-6)
    srt = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    gap = float((srt[:, k - 1] - srt[:, k]).min())
    print(f"{cfg.name}: smallest k-th to (k+1)-th probability gap {gap:.3g}")
    return gap


def test_routing_matches_reference_and_breaks_ties_to_the_lower_index(setup):
    jcfg, cfg, _, _, params_np = setup
    ffn = _layer_ffn(params_np, 0)
    xt = np.random.default_rng(3).normal(size=(64, cfg.d_model)).astype(np.float32)
    assert _routing_agrees(jcfg, cfg, ffn, xt) > 0
    # exact ties: a zero router gives every expert the same probability
    zero = dict(ffn, router=np.zeros_like(ffn["router"]))
    _routing_agrees(jcfg, cfg, zero, xt)
    _, ti = moe.route(map_tree(torch.tensor, zero), torch.from_numpy(xt), cfg.top_k)
    assert (ti == torch.arange(cfg.top_k)).all()


@pytest.mark.parametrize("s", [1, 37])
def test_moe_block_matches_reference(setup, s):
    jcfg, cfg, _, _, params_np = setup
    rng = np.random.default_rng(4)
    x = rng.normal(size=(BATCH, s, cfg.d_model)).astype(np.float32)
    for i in range(cfg.n_layers):
        ffn = _layer_ffn(params_np, i)
        _routing_agrees(jcfg, cfg, ffn, x.reshape(-1, cfg.d_model))
        want = jax_moe.moe_block(jax.tree.map(jnp.asarray, ffn), jnp.asarray(x), jcfg)
        got = moe.moe_block(map_tree(torch.tensor, ffn), torch.from_numpy(x), cfg)
        _close(got, want, 1e-5)


def test_aux_load_balance_loss_matches_reference(setup):
    jcfg, cfg, _, _, params_np = setup
    ffn = _layer_ffn(params_np, 0)
    x = np.random.default_rng(5).normal(size=(BATCH, 40, cfg.d_model)).astype(np.float32)
    want, jg = jax.value_and_grad(
        lambda r: jax_moe.aux_load_balance_loss({"router": r}, jnp.asarray(x), jcfg)
    )(jnp.asarray(ffn["router"]))
    r = torch.from_numpy(ffn["router"]).requires_grad_()
    got = moe.aux_load_balance_loss({"router": r}, torch.from_numpy(x), cfg)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    _close(r.grad, jg, 1e-5)


class _RecordRoutes:
    """Inside the ``with``, every ``moe.route`` call of the port keeps its
    router, input and top-k indices (numpy), for
    ``_routes_match_reference``."""

    def __enter__(self):
        self.calls, self._route = [], moe.route

        def route(p, xt, k, *lay):
            top_p, top_i = self._route(p, xt, k, *lay)
            self.calls.append((p["router"].detach().float().numpy().copy(),
                               xt.detach().float().numpy().copy(), top_i.numpy().copy()))
            return top_p, top_i

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def _routes_match_reference(cfg, calls):
    """Each recorded call's indices equal ``lax.top_k`` of the reference's
    f32 router probabilities on the same input; prints the smallest k-th
    to (k+1)-th gap."""
    assert calls
    k, gap = cfg.top_k, np.inf
    for router, xt, got in calls:
        probs = jax.nn.softmax(jax_moe.proj(jnp.asarray(xt), jnp.asarray(router)), axis=-1)
        np.testing.assert_array_equal(got, np.asarray(jax.lax.top_k(probs, k)[1]))
        srt = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
        gap = min(gap, float((srt[:, k - 1] - srt[:, k]).min()))
    print(f"{cfg.name}: {len(calls)} route calls; smallest k-th to (k+1)-th gap {gap:.3g}")


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
    with _RecordRoutes() as rec:
        tl, tcache = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                   max_len=max_len)
        out = {"prefill": (np.asarray(jl), tl), "steps": []}
        jdecode = jax.jit(jmodel.decode)
        tok = np.asarray(jl)[:, -1:].argmax(-1)
        for _ in range(DECODE_STEPS):
            jl, jcache = jdecode(jparams, jcache, {"token": jnp.asarray(tok, jnp.int32)})
            tl, tcache = model.decode(params, tcache, {"token": torch.from_numpy(tok)})
            out["steps"].append((np.asarray(jl), tl))
            tok = np.asarray(jl).argmax(-1)  # teacher-forced on the reference
    out["launches"] = (before, launch_counts())
    out["routes"] = (cfg, rec.calls)
    out["length"] = tcache["length"]
    return out


def test_prefill_and_decode_routes_match_reference(run):
    _routes_match_reference(*run["routes"])


def test_prefill_logits(run):
    want, got = run["prefill"]
    _close(got, want, TOL)


def test_decode_logits(run):
    assert run["length"] == PROMPT + DECODE_STEPS
    for want, got in run["steps"]:
        _close(got, want, TOL)


def test_cpu_path_launches_no_kernel(run):
    before, after = run["launches"]
    assert before == after


@pytest.fixture(scope="module")
def grads(setup):
    jcfg, cfg, jmodel, model, params_np = setup
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (BATCH, 40)).astype(np.int32)
    batch_np = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    jl, jg = jax.jit(jax.value_and_grad(jmodel.loss))(jax.tree.map(jnp.asarray, params_np),
                                                      jax.tree.map(jnp.asarray, batch_np))
    jg = {p: np.asarray(g) for p, g in leaves(_np(jg))}
    # the load-balance term's gradient in the router of layer 0 alone
    x = jnp.take(jnp.asarray(params_np["embed"]["tok"]), jnp.asarray(tokens), axis=0)
    aux_g = jax.grad(lambda r: 0.01 * jax_moe.aux_load_balance_loss({"router": r}, x, jcfg))(
        jnp.asarray(params_np["layers"]["ffn"]["router"][0]))
    aux = np.zeros_like(params_np["layers"]["ffn"]["router"])
    aux[0] = np.asarray(aux_g)
    out = {}
    for remat in (False, True):
        with _RecordRoutes() as rec:
            tl, tg = loss_and_grads(model, from_numpy(model, params_np),
                                    {k: torch.from_numpy(v) for k, v in batch_np.items()}, remat)
        out[remat] = (float(jl), jg, float(tl), {p: g.numpy() for p, g in leaves(tg)}, aux)
        out[("routes", remat)] = rec.calls
    return cfg, out


@pytest.mark.parametrize("remat", [False, True])
def test_training_routes_match_reference(grads, remat):
    cfg, out = grads
    # remat routes each layer twice (forward, recompute): the same calls again
    assert len(out[("routes", remat)]) == cfg.n_layers * (2 if remat else 1)
    _routes_match_reference(cfg, out[("routes", remat)])


@pytest.mark.parametrize("remat", [False, True])
def test_loss_matches_reference(grads, remat):
    _, out = grads
    jl, _, tl, _, _ = out[remat]
    assert np.isfinite(tl)
    assert abs(tl - jl) <= 1e-5 * abs(jl)


ROUTER = ("layers", "ffn", "router")


@pytest.mark.parametrize("remat", [False, True])
def test_every_gradient_leaf_matches_reference(grads, remat):
    cfg, out = grads
    _, jg, _, tg, aux = out[remat]
    assert jg.keys() == tg.keys()
    for path, want in jg.items():
        got = tg[path]
        assert got.shape == want.shape and np.isfinite(got).all(), path
        assert np.abs(want).max() > 0, path  # the gradient reaches every leaf
        if path == ROUTER and cfg.top_k == 1:
            # p / p: the main loss's derivative is 0; the load-balance term's is all
            _close(got, aux, 1e-5)
            _close(got, want, 5e-3)
            assert not got[1:].any()
            continue
        _close(got, want, 1e-3)


def test_remat_changes_nothing(grads):
    _, out = grads
    _, _, l0, g0, _ = out[False]
    _, _, l1, g1, _ = out[True]
    assert l0 == l1
    for path in g0:
        np.testing.assert_array_equal(g0[path], g1[path])


# --- the loops -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_greedy_tokens_match_reference(arch):
    """``serve_loop`` on the CPU draws its weights and prompts from the
    seed; the same weights and prompts through the reference's greedy
    loop give the same tokens."""
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    batch, prompt_len, gen_tokens, seed = 2, 16, 5, 3
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


def test_train_loop_resumes_bit_for_bit(tmp_path):
    """Reduced deepseek-moe-16b: the loss falls over 12 steps; a fault at
    step 8 resumes from the checkpoint of step 5 and the losses repeat an
    uninterrupted run's bit for bit."""
    cfg = reduced(get_config("deepseek-moe-16b"))
    kw = dict(steps=12, global_batch=2, seq_len=32, log_every=100, device="cpu")
    before = launch_counts()
    _, clean, _ = train_loop(cfg, **kw)
    assert launch_counts() == before  # plain versions on the CPU
    assert np.isfinite(clean).all() and np.mean(clean[-3:]) < np.mean(clean[:3])
    inj = FaultInjector(fail_at_steps=(8,))
    state, losses, _ = train_loop(cfg, ckpt_dir=str(tmp_path), ckpt_every=5,
                                  fault_injector=inj, **kw)
    assert 8 in inj.fired and len(losses) == 15
    assert losses[:8] == clean[:8] and losses[8:] == clean[5:]
    assert int(state["opt"]["step"]) == 12


def test_train_cli_cuts_depth():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = ["repro_torch.launch.train", "--arch", "deepseek-moe-16b", "--smoke", "--layers", "2",
           "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16", "--json"]
    r = subprocess.run([sys.executable, "-m", *cmd], capture_output=True, text=True,
                       timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout)
    assert out["device"]["platform"] == "cpu" and len(out["losses"]) == 2
    assert not any(out["launches"].values())


# --- serving's init --------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b", "zamba2-2.7b",
                                  "xlstm-125m"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_streamed_init_is_bit_identical(arch, compute_dtype):
    cfg = dataclasses.replace(reduced(get_config(arch)), compute_dtype=compute_dtype)
    model = build(cfg, device="cpu")
    want = model.compute_params(model.init(torch.Generator().manual_seed(7)))
    got = model.init_compute(torch.Generator().manual_seed(7))
    want, got = dict(leaves(want)), dict(leaves(got))
    assert want.keys() == got.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        assert torch.equal(got[path], w), path
    if cfg.family == "moe":
        assert got[ROUTER].dtype == torch.float32
        assert got[("layers", "ffn", "wi_gate")].dtype == getattr(torch, compute_dtype)


def test_router_stays_f32_in_compute_params():
    cfg = dataclasses.replace(reduced(get_config("deepseek-moe-16b")), compute_dtype="bfloat16")
    model = build(cfg, device="cpu")
    params = model.compute_params(model.init(torch.Generator().manual_seed(0)))
    assert params["layers"]["ffn"]["router"].dtype == torch.float32
    assert params["layers"]["ffn"]["wo"].dtype == torch.bfloat16
    assert params["layers"]["ffn"]["shared"]["wo"].dtype == torch.bfloat16
