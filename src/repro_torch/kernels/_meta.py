"""The kernels' third branch: meta tensors, which run nothing.

Every wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors. For meta tensors (the dry-run's accounting,
``launch/dryrun.py``) it goes down the CUDA branch up to the launch: it
plans the variant from shapes, strides, dtypes and alignment, allocates
the kernel's outputs and what the CUDA branch saves for the backward;
then, in place of the launch, it charges the kernel's variant and
``Work`` to the open accountings (``launch/accounting.py``), which count
it. The wrappers' ``launches`` and ``variants`` count launches on a card
and nothing else: a meta call leaves them as they were. No other device
takes this branch, and no wrapper takes it by default.

A meta tensor has no address. Its storage is taken to start where the
caching allocator starts one, on 512 bytes, so a view is 16-byte aligned
where its storage offset is (``aligned16``).

``Work`` is one launch's work, defined once beside each wrapper (its
module's ``work``): the bytes it must move, the operations these inputs
need (the bound ``chip_smoke.py`` reports), and the matmul-class FLOPs
that its plain version runs at the same shapes, as
``torch.utils.flop_counter`` counts them, which the accounting charges so
that a meta run and a CPU run of one step count the same FLOPs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["Work", "aligned16", "charge", "einsum_flops", "kernel_device", "visible_pairs"]


class Work(NamedTuple):
    bytes: float  # each input read once, each output written once
    ops: float    # the operations these inputs need
    flops: float  # the plain version's matmul-class FLOPs at these shapes


# The open accountings, callables (kernel name, variant, Work): a module-level list, not
# a context variable, since a backward runs the wrappers on the autograd
# engine's own thread.
_CHARGES: list = []


def kernel_device(t) -> bool:
    """Whether ``t`` takes a wrapper's kernel branch: a CUDA tensor, which
    launches, or a meta tensor, which is charged."""
    return t.device.type in ("cuda", "meta")


def aligned16(*ts) -> bool:
    """Whether every tensor's base lies on 16 bytes: a CUDA tensor's
    address, a meta tensor's storage offset."""
    return all((t.data_ptr() if t.device.type == "cuda" else t.storage_offset()
                * t.element_size()) % 16 == 0 for t in ts)


def charge(kernel: str, variant: str, work: Work) -> None:
    """One meta call of ``kernel``'s ``variant``, charged to every open
    accounting."""
    for fn in _CHARGES:
        fn(kernel, variant, work)


def einsum_flops(*products) -> float:
    """The FLOPs ``torch.utils.flop_counter`` counts for ``torch.einsum``
    products, each given as (the size it contracts, the product of all its
    dims): 2 per multiply-add, none where the contracted size is 1 (einsum
    then multiplies elementwise, with no matmul)."""
    return float(sum(2 * size for contracted, size in products if contracted != 1))


def visible_pairs(sq: int, skv: int, causal: bool, window, q_offset: int,
                  dead: bool = False) -> int:
    """The (query, key) pairs an attention mask leaves visible, queries at
    positions ``q_offset + i`` for i < ``sq``; with ``dead``, the number
    of queries that see no key instead."""
    p = np.arange(sq, dtype=np.int64) + q_offset
    lo = np.maximum(0, p - window + 1) if window is not None else np.zeros_like(p)
    hi = np.minimum(skv, p + 1) if causal else np.full_like(p, skv)
    n = np.maximum(0, hi - lo)
    return int((n == 0).sum() if dead else n.sum())
