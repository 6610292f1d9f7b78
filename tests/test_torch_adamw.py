"""The AdamW step's kernels (``kernels/adamw``) on the CPU, where the
wrappers run their plain versions, against the JAX package.

- ``optim.adamw_update`` (which calls ``adamw`` and ``sum_squares`` a
  leaf at a time) against ``repro.optim.adamw_update`` on the same numpy
  params, gradients and moments, within 4 ulp of each leaf's scale: f32
  and bf16 gradients, a gradient whose squared sum overflows f32 (the
  norm is inf in both packages, so the clip zeroes every gradient), and
  the global norm grouped by mesh axes (``shards=``) on a ``MeshSpec``
  with no process group.
- ``adamw_ref`` bit for bit against the optimizer's in-place update as
  it ran before the kernel (copied below), which the card's kernel is
  held to bit for bit (``tests/test_torch_cuda.py``, ``chip_smoke.py``
  phase 12).
- On meta tensors (the dry-run's accounting) a step charges one
  ``update`` and one ``norm`` launch per leaf, 28 B an f32 element, and
  moves no launch counter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim.adamw import global_norm as jax_global_norm
from repro_torch.kernels import launch_counts
from repro_torch.kernels.adamw import adamw, adamw_ref, norm_work, sum_squares, work
from repro_torch.launch.accounting import Accounting
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models.params import leaves
from repro_torch.optim import OptConfig, adamw_update, global_norm, init_opt_state

CFG = dict(lr=3e-3, warmup_steps=10, total_steps=100, clip_norm=0.5)
SHAPES = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}, "e": [(6, 3), (1,)]}


def _tree(rng, scale=1.0, positive=False, dtype=np.float32):
    def one(shape):
        x = rng.normal(size=shape) * scale
        return (np.abs(x) if positive else x).astype(dtype)
    return jax.tree.map(one, SHAPES, is_leaf=lambda s: isinstance(s, tuple))


def _to_torch(tree, dtype=None):
    def one(x):
        t = torch.from_numpy(np.asarray(x, np.float32).copy())
        return t.to(dtype) if dtype is not None else t
    return jax.tree.map(one, tree)


def _within_ulps(got, want, ulps=4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if not np.isfinite(want).all():
        np.testing.assert_array_equal(got, want)
        return
    scale = np.abs(want).max() if want.size else 0.0
    assert np.abs(got - want).max(initial=0.0) <= ulps * np.spacing(np.float32(scale))


def _step_both(step, grad_scale=1.0, bf16=False, shards=None):
    rng = np.random.default_rng(step)
    params, grads, m = _tree(rng), _tree(rng, grad_scale), _tree(rng)
    v = _tree(rng, positive=True)
    if bf16:  # the same bf16 values on both sides
        grads = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32), grads)
    jgrads = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32), grads)
    jstate = {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
              "step": jnp.int32(step)}
    jp, js, jn = jax_adamw_update(jax.tree.map(jnp.asarray, params), jgrads, jstate,
                                  JaxOptConfig(**CFG))
    tstate = {"m": _to_torch(m), "v": _to_torch(v), "step": torch.tensor(step, dtype=torch.int32)}
    tp, ts, tn = adamw_update(_to_torch(params), _to_torch(grads, torch.bfloat16 if bf16 else None),
                              tstate, OptConfig(**CFG), shards=shards)
    return (jp, js, jn), (tp, ts, tn)


def _assert_steps_agree(jax_out, torch_out):
    (jp, js, jn), (tp, ts, tn) = jax_out, torch_out
    _within_ulps(tn.numpy(), np.asarray(jn))
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        want_leaves = [np.asarray(x) for x in jax.tree.leaves(want)]
        got_leaves = [t.numpy() for _, t in leaves(got)]
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            assert g.dtype == np.float32
            _within_ulps(g, w)


@pytest.mark.parametrize("step", [0, 4, 57])
@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_update_matches_the_reference(step, bf16):
    _assert_steps_agree(*_step_both(step, bf16=bf16))


@pytest.mark.parametrize("bf16", [False, True])
def test_a_norm_that_overflows_is_inf_in_both_packages(bf16):
    """Squares of 1e20 overflow f32: the global norm is inf, the clip
    scale 0, and each leaf decays its moments with a zero gradient, as in
    the reference."""
    jax_out, torch_out = _step_both(3, grad_scale=1e20, bf16=bf16)
    assert np.isinf(np.asarray(jax_out[2])) and torch.isinf(torch_out[2])
    _assert_steps_agree(jax_out, torch_out)


def test_the_norm_grouped_by_mesh_axes_matches_the_reference():
    """``shards=`` on a MeshSpec whose axes have one rank each (no process
    group: each group's psum is the group itself): the leaves summed by
    the mesh axes they split over, then the groups, within 4 ulp of the
    reference's leaf-by-leaf norm; and the update through it."""
    mesh = MeshSpec((1, 1), ("data", "model"))
    spec_of = {("a",): (None, "model"), ("b", "c"): ("data",), ("b", "d"): (None, None, None),
               ("e", 0): (("data", "model"), None), ("e", 1): (None,)}
    rng = np.random.default_rng(11)
    grads = _tree(rng, 3.0)
    want = jax_global_norm(jax.tree.map(jnp.asarray, grads))
    _within_ulps(global_norm(_to_torch(grads), (mesh, spec_of)).numpy(), np.asarray(want))
    _assert_steps_agree(*_step_both(9, shards=(mesh, spec_of)))


def _old_update(p, g, m_, v_, scale, lr, bc1, bc2, cfg):
    """``optim/adamw.py``'s per-leaf update before the kernel, verbatim."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    m_.mul_(b1).add_(g * (1 - b1))
    v_.mul_(b2).add_((g * (1 - b2)).mul_(g))
    del g
    u = m_ / bc1
    u.div_((v_ / bc2).sqrt_().add_(cfg.eps))
    u.add_(cfg.weight_decay * p)
    p.sub_(u.mul_(lr))


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
def test_adamw_ref_is_the_old_update_bit_for_bit(gdtype):
    gen = torch.Generator().manual_seed(5)
    cfg = OptConfig(**CFG)
    p, m = torch.randn(64, 33, generator=gen), torch.randn(64, 33, generator=gen)
    v, g = torch.rand(64, 33, generator=gen), torch.randn(64, 33, generator=gen).to(gdtype)
    scalars = [torch.rand((), generator=gen) + 0.1 for _ in range(4)]
    old = [t.clone() for t in (p, m, v)]
    _old_update(old[0], g, old[1], old[2], *scalars, cfg)
    before = launch_counts()
    adamw(p, g, m, v, *scalars, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
          weight_decay=cfg.weight_decay)
    assert launch_counts() == before  # CPU tensors: the plain version, no launch
    for got, want in zip((p, m, v), old):
        assert torch.equal(got, want)
    new = [t.clone() for t in (p, m, v)]
    adamw_ref(new[0], g, new[1], new[2], *scalars, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
              weight_decay=cfg.weight_decay)
    _old_update(p, g, m, v, *scalars, cfg)
    for got, want in zip(new, (p, m, v)):
        assert torch.equal(got, want)


def test_sum_squares_is_each_leafs_f32_sum_of_squares():
    xs = [torch.randn(5, 7), torch.randn(3).to(torch.bfloat16), torch.randn(4, 6).T]
    got = sum_squares(xs)
    assert got.dtype == torch.float32 and got.shape == (3,)
    for s, x in zip(got, xs):
        assert torch.equal(s, torch.sum(torch.square(x.float())))


def test_a_meta_step_charges_two_launches_a_leaf():
    """The dry-run's accounting: per leaf one ``update`` of 28 B an f32
    element (p, g, m, v read, p, m, v written; 26 with a bf16 gradient)
    and one ``norm`` (the gradient read, one f32 written); no FLOPs; the
    wrappers' launch counters unmoved."""
    params = {"a": torch.empty(10, 20, device="meta"), "b": [torch.empty(7, device="meta")]}
    grads = {"a": torch.empty(10, 20, device="meta", dtype=torch.bfloat16),
             "b": [torch.empty(7, device="meta")]}
    state = init_opt_state(params)
    before = launch_counts()
    with Accounting() as acc:
        adamw_update(params, grads, state, OptConfig())
    assert launch_counts() == before
    assert acc.launches == {"adamw": {"update": 2, "norm": 2}}
    assert work(7, 4).bytes == 28 * 7 and work(200, 2).bytes == 26 * 200
    want = work(200, 2).bytes + work(7, 4).bytes + norm_work(200, 2).bytes + norm_work(7, 4).bytes
    assert acc.kernels["adamw"] == {"flops": 0.0, "bytes": want}


def test_the_kernel_branch_raises_on_what_it_cannot_take():
    """Meta tensors take the kernel's checks: a bf16 parameter, an
    overlapping one (written in place), a scalar off the device."""
    meta = lambda *s, **kw: torch.empty(*s, device="meta", **kw)  # noqa: E731
    one = [meta(()) for _ in range(4)]
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    p, g = meta(4, 4), meta(4, 4)
    with pytest.raises(TypeError, match="f32"):
        adamw(p.bfloat16(), g, meta(4, 4), meta(4, 4), *one, **kw)
    with pytest.raises(ValueError, match="overlap"):
        adamw(meta(4).expand(4, 4), g, meta(4, 4), meta(4, 4), *one, **kw)
    with pytest.raises(ValueError, match="scale"):
        adamw(p, g, meta(4, 4), meta(4, 4), torch.ones(()), *one[1:], **kw)
