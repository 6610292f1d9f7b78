"""Logical-axis sharding: how the paper's dataflows become mesh rules.

The JAX package's rules, with its names. Parameters and activations
carry *logical* axis names ("embed", "heads_flat", "mlp", ...); a
``ShardingRules`` maps them to mesh axes by strategy:

- ``dos`` (paper-faithful): every weight is sharded along its GEMM
  **contraction** axis over ``model``. Each rank computes a K/l partial
  sum, and the cross-rank reduction is the paper's adder pile (an
  all-reduce, or a reduce-scatter where the next GEMM takes a sharded
  layout: the "optimized pile").
- ``megatron``: column-parallel in-projections (output axis sharded),
  row-parallel out-projections (contraction sharded).
- ``zero``: no tensor sharding; the batch spans the whole mesh and
  FSDP shards every weight over it.
- ``auto``: resolved to ``dos`` here, as in the reference's
  ``param_spec``.

FSDP additionally shards each weight's largest remaining axis (by
``_AXIS_WEIGHT``) over the batch axes for training.

A spec is a tuple with one entry per dim: ``None``, a mesh axis name,
or a tuple of names (the dim split over several axes, the first
major), as a ``PartitionSpec`` prints. The rules read only the mesh's
axis names and sizes, so a ``launch.mesh.MeshSpec`` of 16 x 16 gives
the same tables as the reference's mesh of 256 devices. ``shard(x,
kind)`` returns the spec the reference's ``with_sharding_constraint``
would ask of ``x`` (after its divisibility fallbacks), or None with no
rules active; the layers (``models/layers.py``) decide where
the collectives go.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

from ..launch.mesh import axis_names, axis_sizes

__all__ = ["ShardingRules", "use_rules", "current_rules", "shard", "param_sharding",
           "spec_axes", "BATCH_AXES"]

_RULES: contextvars.ContextVar = contextvars.ContextVar("sharding_rules", default=None)

# Mesh axes that carry the batch (data-parallel) dimension.
BATCH_AXES = ("pod", "data")

STRATEGIES = ("dos", "megatron", "zero", "auto")


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: object  # a launch.mesh.MeshSpec or a DeviceMesh
    strategy: str = "dos"  # dos | megatron | zero | auto
    fsdp: bool = True

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy {self.strategy!r}: one of {STRATEGIES}")

    @property
    def axis_names(self) -> tuple:
        return axis_names(self.mesh)

    def batch_axes(self) -> tuple:
        """Mesh axes carrying the batch: the whole mesh under ``zero``,
        else the pod and data axes."""
        if self.strategy == "zero":
            return self.axis_names
        return tuple(a for a in BATCH_AXES if a in self.axis_names)

    def axis_size(self, name: str) -> int:
        return axis_sizes(self.mesh).get(name, 1)

    def parts_size(self, part) -> int:
        """Ranks a spec entry splits a dim over (1 for None)."""
        size = 1
        for a in spec_axes(part):
            size *= self.axis_size(a)
        return size

    # ---- activations ------------------------------------------------------
    def act_spec(self, kind: str) -> tuple:
        """dOS keeps the residual sharded on E (the reduce-scattered adder
        pile's output); megatron replicates it; attention internals are
        sharded on heads, the MLP hidden on F and logits on vocab in
        both; ``zero`` shards activations on the batch only."""
        b = self.batch_axes() or None
        model = "model" if "model" in self.axis_names else None
        if self.strategy == "zero":
            model = None
        dos = self.strategy == "dos"
        table = {
            "residual": (b, None, model if dos else None),
            "attn_heads": (b, None, model, None),
            "mlp_hidden": (b, None, model),
            "logits": (b, None, model),
            "kv_cache": (b, None, model, None),
            "decode_residual": (b, None, model if dos else None),
            "ssm_state": (b, model, None, None),
            "decode_q_kvh": (b, model, None, None),
            "none": (),
        }
        return table[kind]

    # ---- parameters ---------------------------------------------------------
    def param_spec(self, axes: tuple, contract: int | None, out: int | None) -> tuple:
        """The spec of a weight with logical ``axes``; ``contract`` and
        ``out`` index its GEMM contraction and output axes (None for
        norms, biases and tables)."""
        model = "model" if "model" in self.axis_names else None
        if self.strategy == "zero":
            model = None  # no tensor sharding; fsdp below shards storage
        spec: list = [None] * len(axes)
        if model is not None and contract is not None:
            if self.strategy == "megatron":
                # col for in-projections, row for out-projections, whose
                # contraction axes are the inner ones
                shard_idx = contract if axes[contract] in _INNER_AXES else out
            else:  # dos, and auto resolved to dos
                shard_idx = contract
            if shard_idx is not None:
                spec[shard_idx] = model
        if contract is None and "vocab" in axes and model is not None:
            spec[axes.index("vocab")] = model
        if self.fsdp:
            data_axes = self.batch_axes()
            if data_axes:
                free = [i for i in range(len(axes)) if spec[i] is None and axes[i] != "layers"]
                if free:
                    idx = max(free, key=lambda i: _AXIS_WEIGHT.get(axes[i], 1))
                    spec[idx] = data_axes if len(data_axes) > 1 else data_axes[0]
        return tuple(spec)


# Axes that are GEMM-inner ("row-parallel") in the megatron pairing.
_INNER_AXES = {"heads_flat", "mlp", "expert_ff", "ssm_inner"}
# Relative size hints for picking the FSDP axis.
_AXIS_WEIGHT = {
    "vocab": 100, "mlp": 50, "expert_ff": 50, "embed": 40, "heads_flat": 30,
    "ssm_inner": 30, "experts": 20, "heads": 10, "kv_heads": 5, "head_dim": 2,
    "state": 2,
}


def spec_axes(part) -> tuple:
    """The mesh axes of one spec entry, as a tuple (() for None)."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    token = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(token)


def current_rules() -> ShardingRules | None:
    return _RULES.get()


def shard(x, kind: str):
    """The spec the reference constrains activation ``x`` to (None without
    active rules). Entries whose rank count does not divide the dim are
    dropped; a kv cache whose heads cannot take ``model`` is sharded on
    its sequence instead."""
    rules = current_rules()
    if rules is None:
        return None
    nd = len(x.shape)
    parts = list(rules.act_spec(kind))
    parts = (parts + [None] * nd)[:nd]
    for i, part in enumerate(parts):
        if part is None:
            continue
        size = rules.parts_size(part)
        if size == 0 or x.shape[i] % size != 0:
            parts[i] = None
            if kind == "kv_cache" and i == nd - 2 and nd >= 3:
                msize = rules.axis_size("model")
                if part == "model" and parts[nd - 3] is None and x.shape[nd - 3] % msize == 0:
                    parts[nd - 3] = "model"
    return tuple(parts)


def param_sharding(defs, rules: ShardingRules):
    """The spec of every leaf of a ParamDef tree; a leaf whose shards do
    not divide it is replicated (``()``, the reference's ``P()``)."""

    from ..models.params import leaves, unflatten  # here: models import this module

    def one(d):
        spec = rules.param_spec(d.axes, d.contract, d.out)
        if not _divisible(d, spec, rules):
            return ()
        return spec

    return unflatten((path, one(d)) for path, d in leaves(defs))


def _divisible(d, spec, rules: ShardingRules) -> bool:
    return all(dim % rules.parts_size(part) == 0 for dim, part in zip(d.shape, spec))
