"""Collectives over mesh axes, for the sharded layers.

The JAX package has no counterpart: XLA inserts its collectives from the
sharding constraints. Here each is explicit, over one mesh axis or a
tuple of them (a dim split over several axes, the first major, as in a
spec). Every function returns its input, with no call, when the axes
span one rank.

The autograd rules follow one convention: the loss is the same on every
rank of a tensor-parallel group, so a replicated tensor's gradient is
the same on each of them, and a sharded tensor's gradient is its shard
of the full gradient. Hence:

- ``all_reduce`` (sum of partials, e.g. a K-sliced GEMM's): backward
  passes the gradient through;
- ``copy_to``: forward the identity, backward the sum over the group (a
  replicated input to a rank-local computation: a column-parallel GEMM,
  a norm scale applied to local heads);
- ``reduce_scatter``: backward ``all_gather``; ``all_gather``: backward
  takes the rank's slice; ``split`` (a replicated tensor cut to the
  rank's slice): backward ``all_gather``;
- ``gather_params`` (FSDP: a weight gathered over the batch axes just
  before its layer uses it): backward ``reduce_scatter``, the sum of the
  ranks' gradients, each of which saw another part of the batch.

On ``gloo`` a reduce-scatter is an all-reduce and a slice, and bf16 goes
through the collective as f32 (exact for sums of one nonzero term, and
the partial sums here are f32 already).

The pipeline's point-to-point handoffs (``send_recv``) and its loss
``broadcast`` act outside autograd: the GPipe schedule runs its own
backward (``parallel/pipeline.py``).

**Recording and accounting.** Inside ``recording()`` every collective
this rank issues is appended to the yielded list as a ``Collective``:
its op (XLA's names: all-reduce, all-gather, reduce-scatter,
collective-permute, broadcast), the dtype and local shape of the tensor
the layers hand it, and the group's rank count. It is recorded as the
layers ask for it, so a reduce-scatter is one op and bf16 stays bf16
whatever ``gloo`` puts on the wire. A ``MeshSpec`` of several ranks has
no process group: a collective over it raises, except inside
``accounting()`` (the dry-run, ``launch/dryrun.py``) and on meta
tensors, where it records itself, allocates what NCCL's path allocates
and moves nothing. What moves the bytes is ``_all_reduce``,
``_all_gather`` and ``_reduce_scatter``, below the record, so a caller
that stands in for the other ranks (``chip_smoke.py`` on a ``fake``
group) replaces those and is still recorded.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..launch.mesh import MeshSpec, axis_names, axis_sizes
from .axes import spec_axes

__all__ = ["axis_group", "axis_index", "axis_size", "all_reduce", "all_reduce_max", "copy_to",
           "reduce_scatter", "all_gather", "split", "gather_params", "psum", "gather",
           "local_slice", "shard_of", "gather_full", "send_recv", "broadcast", "Collective",
           "recording", "accounting"]


class Collective(NamedTuple):
    """One collective as this rank issues it (``recording``)."""

    op: str       # all-reduce, all-gather, reduce-scatter, collective-permute, broadcast
    dtype: str    # the tensor's, as the layers hand it over ("bfloat16", "float32", ...)
    shape: tuple  # this rank's tensor (a gather's input, a reduce-scatter's whole partial)
    group: int    # ranks in the group

    @property
    def bytes(self) -> int:
        n = getattr(torch, self.dtype).itemsize
        for d in self.shape:
            n *= d
        return n

    @property
    def result_bytes(self) -> float:
        """The result's bytes on this rank, as XLA's HLO shows them."""
        g = self.group
        return {"all-gather": self.bytes * g, "reduce-scatter": self.bytes / g}.get(
            self.op, float(self.bytes))

    @property
    def wire_bytes(self) -> float:
        """Ring bytes on the wire per rank, by ``analysis.roofline``'s factors
        of the result's bytes (its docstring)."""
        g = self.group
        factor = {"all-reduce": 2.0 * (g - 1) / g, "all-gather": (g - 1) / g,
                  "reduce-scatter": float(g - 1)}.get(self.op, 1.0)
        return factor * self.result_bytes


# The lists of the open recording() contexts and the count of open
# accounting() ones: module-level, not context variables, since a backward
# issues its collectives on the autograd engine's own thread.
_LOGS: list = []
_ACCOUNT = [0]


@contextlib.contextmanager
def recording():
    """Yields a list to which every collective issued inside is appended
    as a ``Collective``, in order (rank 0's view on a real or ``fake``
    group; the dry-run's on a ``MeshSpec``)."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


@contextlib.contextmanager
def accounting():
    """Inside, a collective over a ``MeshSpec`` of several ranks takes meta
    tensors: it is recorded, allocates its result as NCCL's path does
    (contiguous, in the tensor's own dtype) and moves nothing."""
    _ACCOUNT[0] += 1
    try:
        yield
    finally:
        _ACCOUNT[0] -= 1


def _note(op: str, x, n: int):
    if _LOGS:
        rec = Collective(op, str(x.dtype).split(".")[-1], tuple(x.shape), n)
        for log in _LOGS:
            log.append(rec)

def axis_size(mesh, axes) -> int:
    """The rank count along ``axes`` (1 for none, whatever the mesh)."""
    axes = spec_axes(axes)
    if not axes:
        return 1
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (row-major, the first axis major)."""
    if isinstance(mesh, MeshSpec):
        return 0
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    sizes = axis_sizes(mesh)
    idx = 0
    for a in spec_axes(axes):
        idx = idx * sizes[a] + coord[a]
    return idx


def axis_group(mesh, axes):
    """The process group of this rank's ranks along ``axes``: the mesh's
    own group of one axis, or the default group for every axis of a mesh
    that spans it (``zero``'s batch; a sum of the shards of a leaf split
    over both axes). A spec's axes are one or all of a (data, model)
    mesh's; where their order matters (a gather, a slice) it is the
    mesh's, the order of the default group's ranks (``_ordered``)."""
    axes = spec_axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if sorted(axes) == sorted(axis_names(mesh)) and mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    raise NotImplementedError(f"a collective over axes {axes} of a mesh {axis_sizes(mesh)} "
                              f"of {dist.get_world_size()} ranks")


def _group(mesh, axes, x):
    """The process group of a collective over ``axes``, or None under
    ``accounting()`` on a ``MeshSpec`` (nothing to move)."""
    if isinstance(mesh, MeshSpec):
        if not _ACCOUNT[0] or x.device.type != "meta":
            raise RuntimeError(f"a collective over axes {spec_axes(axes)} of the mesh "
                               f"{axis_sizes(mesh)} has no process group: a MeshSpec of several "
                               "ranks runs only under collectives.accounting(), on meta tensors")
        return None
    return axis_group(mesh, axes)


def _wire(x):
    """The tensor a collective sends: contiguous, bf16/f16 as f32 on gloo."""
    if x.dtype in (torch.bfloat16, torch.float16) and x.device.type == "cpu":
        return x.float().contiguous()
    return x.contiguous()


# What moves the bytes (each takes the group that _group gave, never None).
def _all_reduce(buf, op, group):
    dist.all_reduce(buf, op=op, group=group)


def _all_gather(parts, buf, group):
    dist.all_gather(parts, buf, group=group)


def _reduce_scatter(out, parts, group):
    dist.reduce_scatter(out, parts, group=group)


def _reduce(x, mesh, axes, op=dist.ReduceOp.SUM, note=True):
    group = _group(mesh, axes, x)
    if note:
        _note("all-reduce", x, axis_size(mesh, axes))
    buf = _wire(x)
    if buf is x:
        buf = buf.clone()
    if group is not None:
        _all_reduce(buf, op, group)
    return buf.to(x.dtype)


def _ordered(mesh, axes):
    """``axes``, which a gather or a slice concatenates in rank order:
    several must be in the mesh's order."""
    axes = spec_axes(axes)
    names = axis_names(mesh)
    if len(axes) > 1 and list(axes) != [a for a in names if a in axes]:
        raise ValueError(f"axes {axes} are not in the order of the mesh's {names}")
    return axes


def _gather(x, mesh, axes, dim):
    axes = _ordered(mesh, axes)
    n = axis_size(mesh, axes)
    group = _group(mesh, axes, x)
    _note("all-gather", x, n)
    buf = _wire(x)
    parts = [torch.empty_like(buf) for _ in range(n)]
    if group is not None:
        _all_gather(parts, buf, group)
    return torch.cat(parts, dim=dim).to(x.dtype)


def _slice(x, mesh, axes, dim):
    axes = _ordered(mesh, axes)
    n = axis_size(mesh, axes)
    return x.chunk(n, dim=dim)[axis_index(mesh, axes)].contiguous()


def _scatter(x, mesh, axes, dim):
    axes = _ordered(mesh, axes)
    n = axis_size(mesh, axes)
    group = _group(mesh, axes, x)
    _note("reduce-scatter", x, n)
    if x.device.type == "cpu":  # gloo: all-reduce, then this rank's slice
        return _slice(_reduce(x, mesh, axes, note=False), mesh, axes, dim)
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    if group is not None:
        _reduce_scatter(out, parts, group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, *ctx.args), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, *ctx.args), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _slice(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _GatherParams(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None, None


def all_reduce(x, mesh, axes):
    """Sum over ``axes``; the gradient passes through."""
    return x if axis_size(mesh, axes) == 1 else _AllReduce.apply(x, mesh, axes)


def all_reduce_max(x, mesh, axes):
    """Max over ``axes`` (no gradient)."""
    return x if axis_size(mesh, axes) == 1 else _reduce(x.detach(), mesh, axes,
                                                         dist.ReduceOp.MAX)


def copy_to(x, mesh, axes):
    """The identity; the gradient is summed over ``axes``."""
    return x if axis_size(mesh, axes) == 1 else _CopyTo.apply(x, mesh, axes)


def reduce_scatter(x, mesh, axes, dim=-1):
    """Sum over ``axes``, each rank keeping its slice of ``dim``."""
    return x if axis_size(mesh, axes) == 1 else _ReduceScatter.apply(x, mesh, axes, dim)


def all_gather(x, mesh, axes, dim=-1):
    """The ranks' slices of ``dim`` concatenated in rank order."""
    return x if axis_size(mesh, axes) == 1 else _AllGather.apply(x, mesh, axes, dim)


def split(x, mesh, axes, dim=-1):
    """This rank's slice of ``dim`` of a replicated tensor."""
    return x if axis_size(mesh, axes) == 1 else _Split.apply(x, mesh, axes, dim)


def gather_params(x, mesh, axes, dim):
    """A weight's FSDP shards over ``axes`` gathered along ``dim``; the
    gradient leaves by reduce-scatter (summed over the ranks)."""
    return x if axis_size(mesh, axes) == 1 else _GatherParams.apply(x, mesh, axes, dim)


def psum(x, mesh, axes):
    """Sum over ``axes``, outside autograd."""
    return x if axis_size(mesh, axes) == 1 else _reduce(x, mesh, axes)


def gather(x, mesh, axes, dim):
    """The ranks' slices of ``dim`` concatenated, outside autograd."""
    return x if axis_size(mesh, axes) == 1 else _gather(x, mesh, axes, dim)


def local_slice(x, mesh, axes, dim):
    """This rank's slice of ``dim``, outside autograd."""
    return x if axis_size(mesh, axes) == 1 else _slice(x, mesh, axes, dim)


def shard_of(x, spec, mesh):
    """This rank's shard of the full tensor ``x`` under ``spec`` (a copy)."""
    for dim, part in enumerate(spec):
        if axis_size(mesh, part) > 1:
            x = x.chunk(axis_size(mesh, part), dim=dim)[axis_index(mesh, part)]
    return x.clone(memory_format=torch.contiguous_format)


def gather_full(x, spec, mesh):
    """The full tensor from every rank's shard under ``spec``."""
    for dim, part in enumerate(spec):
        x = gather(x, mesh, part, dim)
    return x


def send_recv(mesh, axes, sends=(), recvs=()):
    """Point-to-point along ``axes``, outside autograd: ``sends`` are
    (tensor, index) pairs, ``recvs`` (template, index) pairs, an index a
    rank's position along ``axes``. Every send and receive is posted at
    once (``batch_isend_irecv``) and waited for, so two ranks that send
    to each other never both block. Returns the received tensors, each
    of its template's shape and dtype (bf16 crosses ``gloo`` as f32).
    Each send is recorded as a collective-permute."""
    if not sends and not recvs:
        return []
    group = _group(mesh, axes, (sends or recvs)[0][0])
    for x, _ in sends:
        _note("collective-permute", x, axis_size(mesh, axes))
    if group is None:
        return [torch.empty_like(like) for like, _ in recvs]
    ops = [dist.P2POp(dist.isend, _wire(x), dist.get_global_rank(group, i), group)
           for x, i in sends]
    bufs = [(_wire(torch.empty_like(like)), like.dtype, i) for like, i in recvs]
    ops += [dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, i), group)
            for buf, _, i in bufs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [buf.to(dtype) for buf, dtype, _ in bufs]


def broadcast(x, mesh, axes, index: int):
    """The tensor of the rank at ``index`` along ``axes``, on every rank of
    the group (outside autograd)."""
    if axis_size(mesh, axes) == 1:
        return x
    group = _group(mesh, axes, x)
    _note("broadcast", x, axis_size(mesh, axes))
    buf = _wire(x)
    if buf is x:
        buf = buf.clone()
    if group is not None:
        dist.broadcast(buf, src=dist.get_global_rank(group, index), group=group)
    return buf.to(x.dtype)
