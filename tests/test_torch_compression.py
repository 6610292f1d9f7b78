"""int8 error-feedback gradient all-reduce of the port
(``parallel/compression.py``) on ``gloo`` ranks, on the CPU, against the
JAX package's ``compressed_psum_grads`` and a numpy transcription of its
``one_sync``.

One spawn (``tests/_torch_ranks.py`` job ``compress``) runs 8 ranks at
(8, 1), two steps of error feedback each (the second step's gradient
plus the first's residual):

- ``same``: every rank holds the same gradients (the reference's
  ``linspace(-1, 1, 256)`` leaf and two random ones), as the reference's
  ``shard_map`` with replicated inputs takes them; held against the
  reference's values from one ``run_multidevice`` call (8 fake devices,
  ``jax.jit``): ``q`` equal, ``g_hat`` and ``new_err`` within 1 ulp;
- ``own``: each rank its own gradients (which the reference's replicated
  ``in_specs`` cannot take), against the numpy transcription: ``q`` and
  ``new_err`` equal, ``g_hat`` within 2 ulp (``gloo`` sums the 8 scales
  in its own order: one ulp of the scale sum, then the product's
  rounding), and the same on every rank.

The transcription rounds as XLA's compile of the reference does: the
scale ``max|g| * f32(1/127) + 1e-12`` and the residual ``g - q * scale``
are fused multiply-adds there, one rounding each.
"""

import pickle
import threading

import numpy as np
import pytest
import torch

from _torch_ranks import np_one_sync, run_ranks, shared
from conftest import run_multidevice
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.parallel.compression import compressed_psum_grads, init_error_state, quantize

WORLD = 8
F32 = np.float32

_JAX_COMPRESS = """
import pickle, jax, jax.numpy as jnp, numpy as np
from repro.parallel.compression import _quantize, compressed_psum_grads, init_error_state
mesh = jax.make_mesh((8,), ("data",))
steps = pickle.load(open("WORKDIR/same.pkl", "rb"))
sync = jax.jit(lambda g, e: compressed_psum_grads(g, e, mesh))
quant = jax.jit(lambda g, e: jax.tree.map(lambda a, b: _quantize(a + b)[0], g, e))
err = init_error_state(steps[0])
out = []
for g in steps:
    q = quant(g, err)
    g_hat, err = sync(g, err)
    out.append({"q": jax.tree.map(np.asarray, q), "g_hat": jax.tree.map(np.asarray, g_hat),
                "new_err": jax.tree.map(np.asarray, err)})
pickle.dump(out, open("WORKDIR/same_ref.pkl", "wb"))
print("COMPRESS_SAVED")
"""


def _gradients(rng, own: bool):
    """Two steps of gradient trees; each leaf (WORLD, ...), rank r's [r]."""
    steps = []
    for step in range(2):
        base = {"w": np.linspace(-1, 1, 256, dtype=F32).reshape(16, 16) * (step + 1),
                "layers": {"b": (rng.standard_normal(40) * 1e-3).astype(F32),
                           "emb": (rng.standard_normal((3, 7)) * 30).astype(F32)}}
        tree = {}
        for name, a in (("w", base["w"]), ("b", base["layers"]["b"]),
                        ("emb", base["layers"]["emb"])):
            noise = rng.standard_normal((WORLD, *a.shape)).astype(F32) * (a.std() if own else 0)
            tree[name] = (a[None] + noise).astype(F32)
        steps.append({"w": tree["w"], "layers": {"b": tree["b"], "emb": tree["emb"]}})
    return steps


def _np_steps(steps):
    out, err = [], None
    for g in steps:
        step = {}
        new = {}
        for key, a in (("w", g["w"]), ("layers.b", g["layers"]["b"]),
                       ("layers.emb", g["layers"]["emb"])):
            e = np.zeros_like(a) if err is None else err[key]
            q, g_hat, new[key] = np_one_sync(a, e)
            step[key] = {"q": q, "g_hat": g_hat, "new_err": new[key]}
        err = new
        out.append(step)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared(tmp_path_factory, "compress_ranks", _runs)


def _runs(work):
    rng = np.random.default_rng(0)
    cases = {"same": _gradients(rng, own=False), "own": _gradients(rng, own=True)}
    same_one = [{"w": s["w"][0], "layers": {k: v[0] for k, v in s["layers"].items()}}
                for s in cases["same"]]
    (work / "same.pkl").write_bytes(pickle.dumps(same_one))
    (work / "inputs.pkl").write_bytes(pickle.dumps({"compress": cases}))
    jax_out = {}
    code = _JAX_COMPRESS.replace("WORKDIR", str(work))
    th = threading.Thread(target=lambda: jax_out.update(out=run_multidevice(code)))
    th.start()
    try:
        ranks = run_ranks("compress", WORLD, work)
    finally:
        th.join()
    assert "COMPRESS_SAVED" in jax_out["out"]
    ref = pickle.loads((work / "same_ref.pkl").read_bytes())
    ref = [{k: {"w": r[k]["w"], "layers.b": r[k]["layers"]["b"],
                "layers.emb": r[k]["layers"]["emb"]} for k in r} for r in ref]
    own = [{"w": g["w"], "layers.b": g["layers"]["b"], "layers.emb": g["layers"]["emb"]}
           for g in cases["own"]]
    return {"ranks": ranks, "reference": ref, "numpy": _np_steps(cases["own"]), "grads_own": own}


def _within_ulp(got, want, ulps=1):
    got, want = np.asarray(got, dtype=F32), np.asarray(want, dtype=F32)
    return bool((np.abs(got - want) <= ulps * np.spacing(np.abs(want))).all())


LEAVES = ["w", "layers.b", "layers.emb"]
STEPS = [0, 1]


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("leaf", LEAVES)
def test_identical_gradients_match_the_reference(runs, leaf, step):
    got = runs["ranks"]["same"][step][leaf]
    want = {k: runs["reference"][step][k][leaf] for k in ("q", "g_hat", "new_err")}
    for r in range(WORLD):  # every rank: the reference's replicated result
        assert np.array_equal(np.asarray(got["q"][r]), want["q"]), r
        assert _within_ulp(got["g_hat"][r], want["g_hat"]), r
        assert _within_ulp(got["new_err"][r], want["new_err"]), r


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("leaf", LEAVES)
def test_each_ranks_own_gradients_match_one_sync(runs, leaf, step):
    got = runs["ranks"]["own"][step][leaf]
    want = runs["numpy"][step][leaf]
    assert np.array_equal(np.asarray(got["q"]), want["q"].astype(np.int32))
    assert np.array_equal(np.asarray(got["new_err"], dtype=F32), want["new_err"])
    assert all(got["g_hat"][r] == got["g_hat"][0] for r in range(WORLD))
    assert _within_ulp(got["g_hat"][0], want["g_hat"], ulps=2)


def test_error_feedback_carries_the_residual(runs):
    """The second step quantizes its gradient plus the first step's
    residual: without the feedback its q differs from what the ranks sent."""
    steps, got = runs["numpy"], runs["ranks"]["own"][1]
    differs = 0
    for leaf in LEAVES:
        want = steps[1][leaf]["q"]
        assert np.array_equal(np.asarray(got[leaf]["q"]), want.astype(np.int32))
        raw = runs["grads_own"][1][leaf]
        no_feedback = np_one_sync(raw, np.zeros_like(raw))[0]
        differs += int(not np.array_equal(no_feedback, want))
    assert differs > 0


def test_the_reference_bounds_hold():
    """The reference's own test: a linspace leaf synced over one rank
    stays within the int8 error bound, and the residual is what the
    quantizer dropped."""
    g = {"w": torch.linspace(-1, 1, 256).reshape(16, 16)}
    e = init_error_state(g)
    g_hat, new_err = compressed_psum_grads(g, e, make_test_mesh(1, 1))
    assert float((g_hat["w"] - g["w"]).abs().max()) < 1e-2
    assert float(new_err["w"].abs().max()) < 1e-2
    q, scale = quantize(g["w"])
    assert torch.equal(g_hat["w"], q.float() * scale)
    # the residual with one rounding, as XLA's fused multiply-add forms it
    assert torch.equal(new_err["w"], (g["w"].double() - q.double() * scale.double()).float())


def test_init_error_state_is_f32_zeros():
    tree = {"a": torch.ones(3, 2, dtype=torch.bfloat16), "b": [torch.ones(4)]}
    e = init_error_state(tree)
    assert e["a"].dtype == torch.float32 and e["a"].shape == (3, 2) and not e["a"].any()
    assert e["b"][0].shape == (4,) and not e["b"][0].any()


def test_quantize_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, scale = quantize(x)
    assert float(scale) == np.float32(np.float64(127) * np.float64(F32(1) / F32(127))
                                      + np.float64(F32(1e-12)))
    assert q.dtype == torch.int8
    assert q.tolist() == np.clip(np.round(x.numpy() / F32(scale)), -127, 127).astype(int).tolist()
