"""Parameter definition trees.

A model is described by a nested dict of ``ParamDef`` leaves (shape,
logical axes, GEMM contraction/output axis indices, initializer), as in
the JAX package. ``materialize`` turns one into real tensors with the
same init rules (normal x 1/sqrt(fan_in), or the def's own scale; ones;
zeros; Mamba's ``A`` as -[1..H] over the stacking dims) drawn from a ``torch.Generator``, whose stream differs from
``jax.random``'s: parity tests load the reference's weights instead
(``models.convert``).

A tree is nested dicts and lists (the xLSTM's ``blocks`` is a list of
per-layer dicts). The walkers visit them in the reference's flattening
order: a dict by sorted keys, a list by index, with the index as the
path element.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ParamDef", "materialize", "materialize_cast", "tree_size", "stack_defs", "map_tree",
           "leaves", "unflatten", "compute_cast"]

# Leaves the reference reads in f32: the norm scales (rmsnorm; the
# xLSTM's per-block ``ln`` and its blocks' ``norm``), Mamba2's A, dt_bias
# and its gated-norm scale ``norm`` (ssm.py), and the xLSTM's forget-gate
# bias ``bf`` and sLSTM recurrent weights ``r`` (xlstm.py), the MoE
# router, which routes in f32 (moe.py), the vision cross layers' ``gate``
# (tanh in f32, decoder.py) and whisper's cross-attention norm ``lnx`` and
# encoder norm ``enc_norm`` (encdec.py).
_FLOAT_LEAVES_KEPT = ("ln1", "ln2", "ln", "final_norm", "q_norm", "k_norm", "A", "dt_bias",
                      "norm", "bf", "r", "router", "gate", "lnx", "enc_norm")


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple  # logical axis names, len == len(shape)
    contract: int | None = None  # GEMM contraction axis index
    out: int | None = None  # GEMM output axis index
    init: str = "normal"  # normal | zeros | ones | neg_linspace
    scale: float | None = None  # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def map_tree(fn, tree):
    """Apply ``fn`` to the leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def compute_cast(tree, dtype, name=None):
    """``tree`` with every leaf but those of ``_FLOAT_LEAVES_KEPT`` cast to
    ``dtype``: the GEMM weights, biases, Mamba2's ``conv_w`` and ``D``,
    and the embedding table, which the reference casts to the compute
    dtype where it uses them."""
    if isinstance(tree, dict):
        return {k: compute_cast(v, dtype, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [compute_cast(v, dtype) for v in tree]
    return tree if name in _FLOAT_LEAVES_KEPT else tree.to(dtype)


def leaves(tree, path=()):
    """(path, leaf) pairs of nested dicts and lists in the reference's
    flattening order (sorted keys, list indices)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def unflatten(pairs) -> dict:
    """Nested dicts and lists from (path, leaf) pairs, the inverse of
    ``leaves``: a node whose path elements are integers is a list."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(out)


def _draw(d: ParamDef, generator: torch.Generator, dtype):
    """One leaf of ``d`` in ``dtype``, drawn on the generator's device."""
    gen_device = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=gen_device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=gen_device)
    if d.init == "neg_linspace":  # mamba A: -[1..H], broadcast over stacking
        h = d.shape[-1]
        v = -torch.linspace(1.0, float(h), h, device=gen_device).to(dtype)
        return v.expand(d.shape).contiguous()
    if d.init == "normal":
        fan_in = d.shape[d.contract] if d.contract is not None else d.shape[0]
        scale = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        # scaled in place: a stacked expert weight holds billions of values
        return torch.randn(d.shape, generator=generator, device=gen_device).mul_(scale).to(dtype)
    raise ValueError(f"init {d.init!r} is not ported")


def materialize(defs, generator: torch.Generator, dtype=torch.float32, device=None,
                place=None):
    """Initialize real parameters for a ParamDef tree. Values are drawn
    on the generator's device, in the reference's leaf order, then moved
    to ``device``: one seed gives the same weights on every device.
    ``place(path, leaf)``, if given, cuts each drawn leaf to what this
    rank holds (``parallel.plan.shard_tree``'s per-leaf step) before the
    move."""

    def one(path, d: ParamDef):
        t = _draw(d, generator, dtype)
        if place is not None:
            t = place(path, t)
        return t.to(device) if device is not None else t

    return unflatten((path, one(path, d)) for path, d in leaves(defs))  # a fixed draw order


def materialize_cast(defs, generator: torch.Generator, dtype, compute_dtype, device=None,
                     place=None):
    """``compute_cast(materialize(defs, generator, dtype, device, place),
    compute_dtype)``, the same values, formed one leaf at a time: each
    leaf is drawn, moved and cast before the next is drawn, so the device
    never holds the tree in ``dtype`` (deepseek-moe-16b: 67.5 GB in f32,
    33.8 GB in bf16), only its largest leaf."""

    def one(path, d: ParamDef):
        t = _draw(d, generator, dtype)
        if place is not None:
            t = place(path, t)
        return compute_cast(t.to(device) if device is not None else t, compute_dtype, path[-1])

    return unflatten((path, one(path, d)) for path, d in leaves(defs))


def tree_size(defs) -> int:
    """Total parameter count of a ParamDef tree."""
    return sum(math.prod(d.shape) for _, d in leaves(defs))


def stack_defs(defs, n: int, axis_name: str = "layers"):
    """Prepend a stacked-layers dimension to every leaf."""

    def one(d: ParamDef):
        return ParamDef(
            shape=(n,) + d.shape,
            axes=(axis_name,) + d.axes,
            contract=None if d.contract is None else d.contract + 1,
            out=None if d.out is None else d.out + 1,
            init=d.init,
            scale=d.scale,
        )

    return map_tree(one, defs)
