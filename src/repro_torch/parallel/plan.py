"""Placement plans: the spec of every training and serving input.

The JAX package's ``make_plan`` gives, for a (model, shape, rules)
triple, the abstract inputs and in/out shardings of its jitted steps.
Here a plan holds the same placements as spec tuples
(``parallel.axes``), with the abstract inputs as tensors on the
``meta`` device. Decode caches are placed by ``cache_shardings``: batch
over the data axes and the KV heads over ``model``, with the reference's
divisibility fallbacks (heads that do not divide ``model`` shard the
cache's sequence instead, the "ring" layout; a batch that does not
divide the data axes context-shards the sequence over them; state
leaves are sharded on their largest dim).

``shard_tree`` cuts a full tree (``models.convert.from_numpy``'s, or
``materialize``'s) down to this rank's shards under a spec tree;
``gather_tree`` is its inverse, for checkpoints, which hold full arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import ShapeConfig
from ..models.params import leaves, map_tree, unflatten
from .axes import ShardingRules, param_sharding, spec_axes

__all__ = ["Plan", "make_plan", "batch_sharding", "cache_shardings", "serve_cache_specs",
           "shard_place", "shard_tree", "gather_tree", "abstract_cache"]


@dataclasses.dataclass
class Plan:
    rules: ShardingRules
    abstract: tuple  # the step's inputs as meta tensors
    in_shardings: tuple
    out_shardings: Any


def _fit(rules: ShardingRules, shape, parts):
    """Drop spec entries that do not divide the dim."""
    parts = list(parts) + [None] * (len(shape) - len(parts))
    for i, part in enumerate(parts):
        if part is not None and shape[i] % rules.parts_size(part) != 0:
            parts[i] = None
    return parts


def _shape(x):
    return tuple(x.shape)


def batch_sharding(rules: ShardingRules, spec_tree):
    """Token, label and frame inputs: the leading dim over the batch axes
    (where it divides)."""
    b = rules.batch_axes() or None
    return map_tree(lambda s: tuple(_fit(rules, _shape(s), [b])), spec_tree)


def _duplicates(parts) -> list:
    seen, dup = set(), []
    for part in parts:
        for a in spec_axes(part):
            if a in seen:
                dup.append(a)
            seen.add(a)
    return dup


def cache_shardings(rules: ShardingRules, abstract_cache, batch: int):
    """The reference's cache placement with its divisibility fallbacks.
    Leaves that are not tensors (the port's one ``length``) get ``()``.
    Raises where the reference's table maps a mesh axis to two dims
    (``zero`` with ``model`` in the mesh: the batch takes the whole mesh,
    then the heads or the sequence take ``model`` again; the reference's
    ``NamedSharding`` raises ``DuplicateSpecError`` there)."""
    b = rules.batch_axes() or None
    model = "model" if "model" in rules.axis_names else None
    dsize = rules.parts_size(rules.batch_axes())
    msize = rules.axis_size("model") if model else 1
    long_ctx = batch % max(dsize, 1) != 0  # e.g. batch == 1 at 500k

    def one(path, s):
        if not isinstance(s, torch.Tensor):
            return ()
        name = str(path[-1])
        shape = _shape(s)
        nd = len(shape)
        parts = [None] * nd
        if name in ("length", "step") or nd <= 1:
            return tuple(parts)
        if name in ("k", "v") and nd >= 4:
            bdim, sdim, hdim = nd - 4, nd - 3, nd - 2
            if not long_ctx:
                parts[bdim] = b
            elif shape[sdim] % (dsize or 1) == 0:
                parts[sdim] = b  # context-shard the cache sequence
            if model:
                if shape[hdim] % msize == 0:
                    parts[hdim] = model
                elif parts[sdim] is None and shape[sdim] % msize == 0:
                    parts[sdim] = model  # ring decode over the sequence
            return _checked(rules, shape, parts)
        # state leaves: the batch dim is the first of size `batch`; the
        # largest remaining dim takes model
        bdim = next((i for i, d in enumerate(shape) if d == batch), None)
        if bdim is not None and not long_ctx:
            parts[bdim] = b
        if model:
            cands = [i for i in range(nd) if i != bdim and shape[i] % msize == 0
                     and shape[i] >= msize]
            if cands:
                parts[max(cands, key=lambda i: shape[i])] = model
        return _checked(rules, shape, parts)

    return unflatten((path, one(path, s)) for path, s in leaves(abstract_cache))


def _checked(rules, shape, parts):
    parts = _fit(rules, shape, parts)
    dup = _duplicates(parts)
    if dup:
        raise ValueError(f"cache spec {tuple(parts)} maps mesh axis {dup[0]!r} to two dims")
    return tuple(parts)


def serve_cache_specs(rules: ShardingRules, abstract_cache, batch: int):
    """The cache placement serving uses: ``cache_shardings``, except under
    ``zero``, where that table maps ``model`` twice (the reference's
    serve loop never builds it) and the cache takes the layout the
    reference's attention constrains it to (``shard(kc, "kv_cache")``:
    the batch over the whole mesh, where it divides)."""
    if rules.strategy != "zero":
        return cache_shardings(rules, abstract_cache, batch)
    b = rules.batch_axes() or None

    def one(path, s):
        if not isinstance(s, torch.Tensor):
            return ()
        if str(path[-1]) in ("k", "v") and s.ndim >= 4:
            return tuple(_fit(rules, _shape(s), [None] * (s.ndim - 4) + [b]))
        return (None,) * s.ndim

    return unflatten((path, one(path, s)) for path, s in leaves(abstract_cache))


def make_plan(model, shape: ShapeConfig, rules: ShardingRules, *, mode: str | None = None) -> Plan:
    """Abstract inputs (meta tensors) and placements for the step implied
    by ``shape``: ``train`` (params, AdamW state ``m``/``v``/``step``,
    batch; out: params, state, loss), ``prefill`` (params, batch; out:
    logits, cache) or ``decode`` (params, cache, batch; out: logits,
    cache). Serving turns FSDP off and holds the weights in bf16."""
    mode = mode or shape.mode
    cfg = model.cfg
    meta = torch.device("meta")
    if mode == "train":
        ap = _abstract_params(model, getattr(torch, cfg.param_dtype))
        ps = param_sharding(model.defs, rules)
        aos = {"m": ap, "v": ap, "step": torch.empty((), dtype=torch.int32, device=meta)}
        oss = {"m": ps, "v": ps, "step": ()}
        specs = _input_specs(cfg, shape)
        bs = batch_sharding(rules, specs)
        return Plan(rules=rules, abstract=(ap, aos, specs), in_shardings=(ps, oss, bs),
                    out_shardings=(ps, oss, ()))

    ap = _abstract_params(model, torch.bfloat16)
    ps = param_sharding(model.defs, dataclasses.replace(rules, fsdp=False))
    specs = _input_specs(cfg, shape)
    bs = batch_sharding(rules, specs)
    b = shape.global_batch
    ac = abstract_cache(model.cfg, b, shape.seq_len, torch.bfloat16)
    cs = cache_shardings(rules, ac, b)
    if mode == "prefill":
        logits_s = tuple(_fit(rules, (b, shape.seq_len, cfg.vocab),
                              [rules.batch_axes() or None, None, "model"]))
        return Plan(rules=rules, abstract=(ap, specs), in_shardings=(ps, bs),
                    out_shardings=(logits_s, cs))
    long_ctx = b == 1
    logits_s = tuple(_fit(rules, (b, 1, cfg.vocab),
                          [None if long_ctx else (rules.batch_axes() or None), None, "model"]))
    return Plan(rules=rules, abstract=(ap, ac, specs), in_shardings=(ps, cs, bs),
                out_shardings=(logits_s, cs))


def abstract_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """The cache tree of ``cfg`` as meta tensors (no memory). Made outside
    any dispatch mode: a decode step that reads its placement inside the
    dry-run's accounting (``launch/accounting.py``) allocates nothing."""
    from torch.utils._python_dispatch import _disable_current_modes

    from ..models.decoder import init_cache
    from ..models.encdec import encdec_init_cache

    fn = encdec_init_cache if cfg.family == "encdec" else init_cache
    with _disable_current_modes():
        return fn(cfg, batch, max_len, dtype, torch.device("meta"))


def _abstract_params(model, dtype):
    return map_tree(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), model.defs)


def _input_specs(cfg, shape: ShapeConfig) -> dict:
    """The step's batch as meta tensors, as the reference's
    ``Model.input_specs``: tokens and labels (B, S) in train, the prompt
    in prefill, one token in decode, plus the vision model's image
    embeddings and whisper's frames where the mode takes them."""
    from ..models.zoo import MODEL_INPUTS

    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    tok = lambda n: torch.empty((b, n), dtype=torch.int32, device=meta)  # noqa: E731
    if shape.mode == "train":
        out = {"tokens": tok(s), "labels": tok(s)}
    elif shape.mode == "prefill":
        out = {"tokens": tok(s)}
    else:
        return {"token": tok(1)}
    if cfg.family in MODEL_INPUTS:
        name, length = MODEL_INPUTS[cfg.family]
        out[name] = torch.empty((b, getattr(cfg, length), cfg.d_model),
                                dtype=getattr(torch, cfg.compute_dtype), device=meta)
    return out


# ---- this rank's shards ------------------------------------------------------


def shard_place(specs, mesh):
    """``place(path, leaf)``: this rank's shard of one full leaf under the
    spec tree ``specs`` (a copy, so the full leaf can be freed)."""
    from .collectives import shard_of

    spec_of = dict(leaves(specs))
    return lambda path, t: shard_of(t, spec_of[path], mesh)


def shard_tree(tree, specs, mesh):
    """This rank's shard of every leaf of the full ``tree`` under the spec
    tree ``specs``."""
    place = shard_place(specs, mesh)
    return unflatten((path, place(path, t)) for path, t in leaves(tree))


def gather_tree(tree, specs, mesh):
    """The full tree from every rank's shards (every rank gets it)."""
    from .collectives import gather_full

    spec_of = dict(leaves(specs))
    return unflatten((path, gather_full(t, spec_of[path], mesh)) for path, t in leaves(tree))
