"""What one rank's step costs, counted on the meta device.

``account(fn, *args)`` runs ``fn`` once on meta tensors and returns its
output and a ``Record``: what XLA's ``cost_analysis``,
``memory_analysis`` and compiled HLO give the JAX package's dry-run, and
the kernel launches, which XLA cannot give. Inside it:

- ``Accounting``, a ``TorchDispatchMode``, sees every aten op. FLOPs:
  the matmul-class ops by ``torch.utils.flop_counter``'s formulas, plus
  what each kernel wrapper's meta branch charges (``kernels/_meta.py``:
  its plain version's FLOPs at the same shapes, so that a meta run counts
  what a CPU run of the plain versions counts). Bytes accessed: the
  bytes every op that is not a view or a bare allocation reads and
  writes, plus the kernels' charges. Live bytes: every storage an op
  allocates, rounded up to the caching allocator's 512 bytes, from its
  allocation to its release (a weakref finalizer on the storage), and
  their peak. Launches: by kernel and variant, what the wrappers' meta
  branches charge (a card's launches are the wrappers' own counters,
  which a meta call leaves as they were).
  Under any dispatch mode the autograd engine sums two gradients of one
  input out of place (``InputBuffer``: a mode makes every tensor
  "subclass-like"), where without one it adds the second into the first
  when it holds the only reference; and a few backward formulas fill
  fresh zeros out of place (gather's ``scatter_add``, ``_IN_PLACE``).
  ``Accounting`` hooks every node of a graph that ``torch.autograd.grad``
  or ``backward`` runs and tells the adds the engine makes between two
  nodes from a formula's. It runs every op as it was called; where the
  card would have run it in place, it books the result on the input's
  storage, which the card would have written, so that the live bytes
  are the card's (phase 20 of ``chip_smoke.py`` holds them to it).
- ``collectives.accounting()`` lets the layers' collectives run over a
  ``MeshSpec`` (rank 0 of a mesh that no process group spans) and
  ``collectives.recording()`` keeps each one that rank 0 issues.

Nothing is computed, so a step of a 72 B model at 256 ranks is counted
in seconds on the host, and a value read on the host (``.item()``,
``.tolist()``) fails, as it would be a sync on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref

import torch
from torch.autograd.function import BackwardCFunction
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..analysis.roofline import CollectiveStats
from ..kernels import _meta
from ..parallel import collectives as C

__all__ = ["GRANULE", "Accounting", "Record", "account", "collective_stats", "tree_bytes"]

GRANULE = 512  # bytes: the caching allocator rounds every block up to this
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a nested tuple, list or dict, each by its
    own elements."""
    return sum(_bytes(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


_A = torch.ops.aten
_ADD = _A.add.Tensor
# Backward formulas that fill a fresh zero tensor in place, and out of place
# under a dispatch mode (``areAnyTensorSubclassLike`` in autograd's
# FunctionsManual): gather's, sort's and topk's, index_select's,
# masked_select's and index's backward.
_IN_PLACE = {_A.scatter_add.default, _A.scatter.src, _A.index_add.default,
             _A.masked_scatter.default, _A.index_put.default}


def _refs(t) -> tuple:
    return t._use_count(), torch._C._storage_Use_Count(t.untyped_storage()._cdata)


def _dense(t) -> bool:
    """Whether ``t``'s elements fill its span with no overlap (its strides,
    ordered, are a contiguous tensor's of some permutation)."""
    step = 1
    for stride, size in sorted((st, n) for n, st in zip(t.shape, t.stride()) if n != 1):
        if stride != step:
            return False
        step *= size
    return True


class Accounting(TorchDispatchMode):
    """FLOPs, bytes accessed, live bytes and launches of what runs inside
    (see the module docstring). ``peak`` is the most that storages
    allocated inside held at once; storages that existed before (the
    step's arguments) are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: dict = {}  # kernel -> {"flops", "bytes"} charged
        self.launches: dict = {}  # kernel -> {variant: meta calls charged}
        self.live = 0
        self.peak = 0
        self._alive: dict = {}
        self._between = False  # a node has run, the next has not: the engine's own adds
        self._sole = None  # _refs of what only the engine or a formula holds, seen from here

    def __enter__(self):
        _meta._CHARGES.append(self._charge)
        self._patches = contextlib.ExitStack()
        for mod, name in ((torch.autograd, "grad"), (torch.autograd, "backward")):
            self._patches.enter_context(_patched(mod, name, self._hooked(getattr(mod, name))))
        out = super().__enter__()
        if self._sole is None:
            self._sole = self._probe()
            self.flops = self.bytes = 0.0  # the probe's work is not the caller's
            self.peak = self.live
        return out

    def __exit__(self, *exc):
        self._patches.close()
        _meta._CHARGES.remove(self._charge)
        return super().__exit__(*exc)

    def _charge(self, kernel, variant, work):
        self.flops += work.flops
        self.bytes += work.bytes
        k = self.kernels.setdefault(kernel, {"flops": 0.0, "bytes": 0.0})
        k["flops"] += work.flops
        k["bytes"] += work.bytes
        by = self.launches.setdefault(kernel, {})
        by[variant] = by.get(variant, 0) + 1

    def _free(self, key):
        self.live -= self._alive.pop(key, 0)

    def _hooked(self, run):
        """``torch.autograd.grad`` or ``backward`` with every node of the
        graph from its outputs hooked: before it runs, and after (when the
        engine adds its outputs into the next nodes' buffers)."""

        def start(*_):
            self._between = False

        def end(*_):
            self._between = True

        def call(tensors, *args, **kwargs):
            roots = [tensors] if isinstance(tensors, torch.Tensor) else list(tensors)
            todo = [t.grad_fn for t in roots if t.grad_fn is not None]
            seen, handles = set(), []
            while todo:
                node = todo.pop()
                if node is None or node in seen:
                    continue
                seen.add(node)
                handles += [node.register_prehook(start), node.register_hook(end)]
                todo += [n for n, _ in node.next_functions]
            try:
                return run(tensors, *args, **kwargs)
            finally:
                self._between = False
                for h in handles:
                    h.remove()

        return call

    def _probe(self):
        """``_refs``, seen from inside this mode (the references the call
        itself holds included), of tensors that only the engine or a
        backward formula holds: the first of two gradients of one input that
        the engine sums, and the fresh zeros gather's backward scatters
        into."""
        seen = []

        def record(func, args):  # book nothing
            seen.append((func, [_refs(a) for a in args[:2] if isinstance(a, torch.Tensor)]))

        self._written, self._sole = record, ()
        try:
            x = torch.empty(2, device="meta", requires_grad=True)
            i = torch.zeros(2, dtype=torch.int64, device="meta")
            torch.autograd.grad((x * 2).sum() + (x * 3).sum() + x.gather(0, i).sum(), [x])
        finally:
            del self._written
        add = next(refs for func, refs in seen if func is _ADD)
        fill = next(refs for func, refs in seen if func is not _ADD)
        return add[0], fill[0]

    def _written(self, func, args):
        """The input the card writes the result into, where only this mode
        made the call out of place, else None: the engine's sum of two
        gradients of one input, ``a`` (in its buffer) and ``b`` (arriving),
        goes into ``a`` where it alone holds ``a`` and its storage and ``a``
        is dense (``InputBuffer::accumulate``); a backward formula's fill of
        fresh zeros (``_IN_PLACE``) goes into the zeros."""
        def sole(x, refs, y=None):
            return (_refs(x) == refs and _dense(x) and (y is None or (
                x.dtype == torch.result_type(x, y)
                and x.shape == torch.broadcast_shapes(x.shape, y.shape))))

        if func is _ADD:
            return args[0] if sole(args[0], self._sole[0], args[1]) else None
        return args[0] if sole(args[0], self._sole[1]) else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        into = None
        if self._sole is not None and torch._C._current_graph_task_id() != -1 and (
                (func is _ADD and self._between and not kwargs and len(args) == 2)
                or (func in _IN_PLACE and not self._between
                    and not isinstance(torch._C._current_autograd_node(), BackwardCFunction))):
            into = self._written(func, args)
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view:
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if packet.__name__ not in _ALLOCATIONS:
            self.bytes += sum(map(_bytes, ins)) + sum(map(_bytes, outs))
        if into is not None:  # the card's result lives where ``into`` did
            size = self._alive.pop(into.untyped_storage()._cdata, None)
            if size is not None:
                self._book(out.untyped_storage(), size)
            return out
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if st._cdata in held or st._cdata in self._alive or st.nbytes() == 0:
                continue
            self._book(st, -(-st.nbytes() // GRANULE) * GRANULE)
            self.live += self._alive[st._cdata]
            self.peak = max(self.peak, self.live)
        return out

    def _book(self, storage, size):
        """``size`` live bytes held by ``storage`` until it is released."""
        self._alive[storage._cdata] = size
        weakref.finalize(storage, self._free, storage._cdata)


@contextlib.contextmanager
def _patched(mod, name, value):
    old = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, old)


@dataclasses.dataclass
class Record:
    """One accounted call: FLOPs and bytes accessed (aten ops and kernel
    charges), the peak of the bytes allocated inside, the launches by
    kernel and variant, each kernel's charges, rank 0's collectives in
    order, the output's bytes and the host seconds the trace took."""

    flops: float
    bytes: float
    peak_bytes: int
    launches: dict
    kernels: dict
    collectives: list
    output_bytes: int
    seconds: float


def account(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), Record)``: one call on meta tensors, rank 0
    of whatever ``MeshSpec`` the active sharding rules hold."""
    t0 = time.perf_counter()
    with C.accounting(), C.recording() as log, Accounting() as acc:
        out = fn(*args, **kwargs)
    return out, Record(flops=acc.flops, bytes=acc.bytes, peak_bytes=acc.peak,
                       launches=acc.launches, kernels=acc.kernels, collectives=list(log),
                       output_bytes=tree_bytes(out), seconds=time.perf_counter() - t0)


def collective_stats(log) -> CollectiveStats:
    """The roofline's ``CollectiveStats`` of recorded collectives: wire
    bytes by ``analysis.roofline``'s op factors, result bytes, counts."""
    counts: dict = {}
    by_op: dict = {}
    for c in log:
        counts[c.op] = counts.get(c.op, 0) + 1
        by_op[c.op] = by_op.get(c.op, 0.0) + c.wire_bytes
    return CollectiveStats(wire_bytes=sum(c.wire_bytes for c in log),
                           result_bytes=sum(c.result_bytes for c in log), counts=counts,
                           by_op_bytes=by_op)
