"""Analytical performance model for 2D and 3D systolic arrays.

Implements and extends the runtime model of the paper (Eqs. 1 and 2),
which itself extends SCALE-Sim's [13, Eq. (4)] output-stationary model.

A GEMM workload is ``A(M x K) @ B(K x N)``. For an output-stationary (OS)
2D array with R rows and C columns (``N_macs = R*C``):

    tau_2d = (2R + C + K - 2) * ceil(M/R) * ceil(N/C)          (Eq. 1)

For the distributed-output-stationary (dOS) 3D array with ``l`` tiers of
R' x C' each (``N_macs = l * R' * C'``), the contraction dim K is split
across tiers (each works on K/l) and the partial sums are accumulated
down the tier pile with ``l - 1`` sequential adds:

    tau_3d = (2R' + C' + (ceil(K/l) + l - 1) - 2)
             * ceil(M/R') * ceil(N/C')                          (Eq. 2)

All four dataflows of the paper (Sec. III-C) share the same structural
form: a per-fold latency ``2R + C + T - 2`` (array fill + drain + the
temporal dimension ``T``) times a fold count over the two spatially
mapped dimensions.  ``dataflow_dims`` maps each dataflow onto that
(D_rows, D_cols, T) triple, which is what lets a *single* batched search
kernel (``optimize_rc_batched`` / ``_search_rc``) serve OS, WS, IS and
dOS alike — the engine (``core.engine``) evaluates thousands of design
points through it in one vectorized pass.

The scalar optimizers (``optimize_array_2d`` / ``optimize_array_3d``)
delegate to the batched kernel with a batch of one, so the per-point and
batched paths are the same code and can never disagree.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

__all__ = [
    "GEMM",
    "tau_2d",
    "tau_3d",
    "tau_ws",
    "tau_is",
    "dataflow_dims",
    "FOLD_NAMES",
    "native_fold",
    "fold_dims",
    "optimize_rc_batched",
    "optimize_array_2d",
    "optimize_array_3d",
    "speedup_3d",
    "optimal_tiers",
    "mac_threshold",
    "ArrayPlan",
]

OptMode = Literal["opt", "square"]

#: Sentinel runtime for invalid design points (e.g. per-tier budget < 1).
INVALID_CYCLES = np.iinfo(np.int64).max


@dataclasses.dataclass(frozen=True)
class GEMM:
    """A GEMM workload ``A(M x K) @ B(K x N)``."""

    M: int
    K: int
    N: int
    name: str = ""

    @property
    def flops(self) -> int:
        return 2 * self.M * self.K * self.N

    @property
    def macs(self) -> int:
        return self.M * self.K * self.N


@dataclasses.dataclass(frozen=True)
class ArrayPlan:
    """A chosen array configuration and its predicted runtime (cycles)."""

    rows: int
    cols: int
    tiers: int
    cycles: float
    n_macs_used: int
    #: useful MAC-ops of the workload (M*K*N); optimizers fill this in so
    #: ``utilization`` is defined. ``None`` for hand-built plans.
    workload_macs: int | None = None

    @property
    def utilization(self) -> float:
        """Useful MAC-ops per provisioned MAC-cycle (<= 1)."""
        if not self.workload_macs or not self.n_macs_used or not self.cycles:
            return np.nan
        return self.workload_macs / (self.n_macs_used * self.cycles)


def _ceil_div(a, b):
    return -(-np.asarray(a) // np.asarray(b))


def tau_2d(M, K, N, R, C):
    """Eq. 1 — runtime in cycles of an OS 2D array (vectorized)."""
    M, K, N, R, C = np.broadcast_arrays(
        *(np.asarray(x, dtype=np.int64) for x in (M, K, N, R, C))
    )
    return (2 * R + C + K - 2) * _ceil_div(M, R) * _ceil_div(N, C)


def tau_3d(M, K, N, R, C, tiers):
    """Eq. 2 — runtime in cycles of a dOS 3D array (vectorized).

    ``R, C`` are the *per-tier* dimensions. ``tiers == 1`` exactly
    recovers Eq. 1 (a property test asserts this).
    """
    M, K, N, R, C, L = np.broadcast_arrays(
        *(np.asarray(x, dtype=np.int64) for x in (M, K, N, R, C, tiers))
    )
    k_per_tier = _ceil_div(K, L)
    return (2 * R + C + (k_per_tier + L - 1) - 2) * _ceil_div(M, R) * _ceil_div(N, C)


def tau_ws(M, K, N, R, C, tiers=1):
    """Weight-stationary runtime (vectorized): N, K spatial; M temporal.

    B is pre-loaded (N mapped to rows, K to columns); A streams through
    for M cycles per fold. Extended to ``tiers`` > 1 the temporal dim M
    is split across tiers with **no** cross-tier traffic (WS-in-3D
    degenerates to model parallelism, paper Sec. III-C):

        tau_ws = (2R + C + ceil(M/l) - 2) * ceil(N/R) * ceil(K/C)
    """
    M, K, N, R, C, L = np.broadcast_arrays(
        *(np.asarray(x, dtype=np.int64) for x in (M, K, N, R, C, tiers))
    )
    return (2 * R + C + _ceil_div(M, L) - 2) * _ceil_div(N, R) * _ceil_div(K, C)


def tau_is(M, K, N, R, C, tiers=1):
    """Input-stationary runtime (vectorized): M, K spatial; N temporal.

    A is pre-loaded (M mapped to rows, K to columns); B streams through
    for N cycles per fold. Extended to ``tiers`` > 1 the temporal dim N
    is split across tiers with no cross-tier traffic:

        tau_is = (2R + C + ceil(N/l) - 2) * ceil(M/R) * ceil(K/C)
    """
    M, K, N, R, C, L = np.broadcast_arrays(
        *(np.asarray(x, dtype=np.int64) for x in (M, K, N, R, C, tiers))
    )
    return (2 * R + C + _ceil_div(N, L) - 2) * _ceil_div(M, R) * _ceil_div(K, C)


def dataflow_dims(dataflow: str, M, K, N, tiers):
    """Map a dataflow onto the generic (D_rows, D_cols, T_serial) triple.

    Every dataflow's runtime is ``(2R + C + T_serial - 2) * ceil(D_rows/R)
    * ceil(D_cols/C)``:

    - ``os`` / ``dos``: M, N spatial; T = ceil(K/l) + (l-1) cross-tier
      adds (l = 1 recovers plain OS / Eq. 1).
    - ``ws``: N, K spatial; T = ceil(M/l)  (M split across tiers, no
      vertical traffic).
    - ``is``: M, K spatial; T = ceil(N/l).
    """
    M, K, N, L = (np.asarray(x, dtype=np.int64) for x in (M, K, N, tiers))
    if dataflow in ("os", "dos"):
        return M, N, _ceil_div(K, L) + L - 1
    if dataflow == "ws":
        return N, K, _ceil_div(M, L)
    if dataflow == "is":
        return M, K, _ceil_div(N, L)
    raise ValueError(f"unknown dataflow {dataflow!r}")


#: the three tier folds: which GEMM dimension the stack of l tiers
#: partitions. Canonical candidate order for the ``tier_fold`` policy.
FOLD_NAMES = ("m", "k", "n")


def native_fold(dataflow: str) -> str:
    """The dataflow's *paper* tier split — the dimension its 3D
    extension already folds across tiers.

    os/dos fold the contraction dim K (Eq. 2's ``ceil(K/l) + l - 1``);
    ws folds the temporal M; is folds the temporal N. ``fold_dims``
    with the native fold is exactly ``dataflow_dims``.
    """
    if dataflow in ("os", "dos"):
        return "k"
    if dataflow == "ws":
        return "m"
    if dataflow == "is":
        return "n"
    raise ValueError(f"unknown dataflow {dataflow!r}")


def fold_dims(fold: str | None, dataflow: str, M, K, N, tiers):
    """(D_rows, D_cols, T_serial) of a dataflow under a chosen tier fold.

    A *fold* names which GEMM dimension the l tiers partition. The
    native fold (``native_fold(dataflow)``, or ``fold=None``) is the
    paper's 3D extension and returns ``dataflow_dims`` unchanged. The
    two non-native folds split a different dimension into balanced
    ``ceil``-sized per-tier slices; each tier then runs the dataflow's
    own 2D schedule on its slice:

    - splitting an output dim (m or n for os/dos; n for ws; m for is)
      yields l independent sub-GEMMs: the split dim shrinks to
      ``ceil(dim/l)`` and the serial/temporal term runs at full depth;
    - splitting the contraction dim K on ws/is mirrors dOS: the K
      extent of the spatial map shrinks to ``ceil(K/l)`` and the
      temporal term pays ``l - 1`` cross-tier partial-sum adds.

    All triples degenerate to the dataflow's 2D dims at ``tiers == 1``,
    so every fold is exactly the native mapping on a single tier.
    """
    if fold is None or fold == native_fold(dataflow):
        return dataflow_dims(dataflow, M, K, N, tiers)
    M, K, N, L = (np.asarray(x, dtype=np.int64) for x in (M, K, N, tiers))
    if dataflow in ("os", "dos"):
        if fold == "m":
            return _ceil_div(M, L), N, K
        if fold == "n":
            return M, _ceil_div(N, L), K
    elif dataflow == "ws":
        if fold == "k":
            return N, _ceil_div(K, L), M + L - 1
        if fold == "n":
            return _ceil_div(N, L), K, M
    elif dataflow == "is":
        if fold == "k":
            return M, _ceil_div(K, L), N + L - 1
        if fold == "m":
            return _ceil_div(M, L), K, N
    raise ValueError(f"unknown fold {fold!r} for dataflow {dataflow!r}")


def _search_rc(xp, D1, D2, Tser, budget, r_max_total: int):
    """Batched rectangular (R, C) search — the engine's hot kernel.

    ``xp`` is ``numpy``; the engine's torch backend runs the same search
    as ``_search_rc_torch``. All of D1/D2/Tser/budget are int64 arrays of shape (B,); the search
    enumerates R in [1, r_max_total] for every batch element at once and
    masks candidates beyond each element's own ``min(D1, budget)``.

    Candidate enumeration, ordering and tie-breaking mirror the original
    three-variant scalar search exactly (ascending R, first minimum
    wins), so a batch of one reproduces it bit-for-bit — but only one
    tau per candidate is evaluated: of the original variants
    {(R, C_cap), (R, C2), (R2, C2)} the fold-tightened (R2, C2) always
    wins, since C2 = ceil(D2/ceil(D2/C_cap)) <= C_cap and
    R2 = ceil(D1/ceil(D1/R)) <= R leave both fold counts unchanged
    while shrinking the per-fold fill term 2R + C.
    """
    if xp is np and (
        max(int(D1.max(initial=0)), int(D2.max(initial=0)), int(budget.max(initial=0)))
        < 2**52
    ):
        # numpy's integer floordiv is a scalar loop while float64 math is
        # SIMD, and float64 is *exact* on integers < 2^53: every ceil-div
        # here has quotient*divisor <= dividend < 2^52, so
        # floor(fl((a+b-1)/b)) == ceil(a/b) holds exactly. tau products
        # are guarded below and fall back to int64 on overflow.
        out = _search_rc_f64(D1, D2, Tser, budget, r_max_total)
        if out is not None:
            return out
    D1 = D1[:, None]
    D2 = D2[:, None]
    Tser = Tser[:, None]
    budget = budget[:, None]
    R = xp.arange(1, r_max_total + 1, dtype=xp.int64)[None, :]
    valid = R <= xp.minimum(D1, budget)
    foldM = -(-D1 // R)
    C1 = xp.minimum(xp.maximum(budget // R, 1), D2)
    f = -(-D2 // C1)
    C2 = -(-D2 // f)  # tightened: same folds, smaller C
    R2 = -(-D1 // foldM)  # tightened: same folds, smaller R
    taus = (2 * R2 + C2 + Tser - 2) * (foldM * f)
    taus = xp.where(valid, taus, INVALID_CYCLES)
    i = xp.argmin(taus, axis=1)[:, None]

    def take(a):
        return xp.take_along_axis(xp.broadcast_to(a, taus.shape), i, axis=1)[:, 0]

    return take(R2), take(C2), take(taus)


def _search_rc_torch(D1, D2, Tser, budget, r_max_total: int):
    """``_search_rc`` on int64 torch tensors, on whatever device they lie.

    The same candidates, formulas and order as the int64 numpy path,
    with no float64 shortcut: every ceil-div is exact integer math at any
    magnitude. ``torch.argmin`` returns the first minimum on every
    device, so ties break toward the smallest R, as in numpy. Returns
    ``(R, C, tau)`` int64 tensors of shape (B,) on the inputs' device.
    """
    D1, D2, Tser, budget = (x[:, None] for x in (D1, D2, Tser, budget))
    R = torch.arange(1, r_max_total + 1, dtype=torch.int64, device=D1.device)[None, :]
    valid = R <= torch.minimum(D1, budget)
    foldM = -(-D1 // R)
    C1 = torch.minimum(torch.clamp(budget // R, min=1), D2)
    f = -(-D2 // C1)
    C2 = -(-D2 // f)  # tightened: same folds, smaller C
    R2 = -(-D1 // foldM)  # tightened: same folds, smaller R
    taus = (2 * R2 + C2 + Tser - 2) * (foldM * f)
    taus = torch.where(valid, taus, INVALID_CYCLES)
    i = torch.argmin(taus, dim=1, keepdim=True)

    def take(a):
        return torch.gather(a.expand(taus.shape), 1, i)[:, 0]

    return take(R2), take(C2), take(taus)


def _search_rc_f64(D1, D2, Tser, budget, r_max_total: int):
    """All-float64 numpy fast path of ``_search_rc``.

    Identical results by construction (every intermediate is an exactly
    represented integer); returns None when a tau candidate reaches
    2^53, in which case the caller reruns the chunk in int64.
    """
    D1f = D1.astype(np.float64)[:, None]
    D2f = D2.astype(np.float64)[:, None]
    Tf = Tser.astype(np.float64)[:, None]
    bf = budget.astype(np.float64)[:, None]
    Rf = np.arange(1.0, r_max_total + 1.0)[None, :]
    foldM = np.floor((D1f + Rf - 1.0) / Rf)
    C1 = np.minimum(np.maximum(np.floor(bf / Rf), 1.0), D2f)
    f = np.floor((D2f + C1 - 1.0) / C1)
    C2 = np.floor((D2f + f - 1.0) / f)  # tightened: same folds, smaller C
    R2 = np.floor((D1f + foldM - 1.0) / foldM)  # tightened, same folds
    taus = (2.0 * R2 + C2 + Tf - 2.0) * (foldM * f)
    if np.max(taus, initial=0.0) >= 2.0**53:
        return None
    taus = np.where(Rf <= np.minimum(D1f, bf), taus, np.inf)
    i = np.argmin(taus, axis=1)[:, None]

    def take(a):
        sel = np.take_along_axis(np.broadcast_to(a, taus.shape), i, axis=1)[:, 0]
        return sel.astype(np.int64)

    r, c = take(R2), take(C2)
    t = np.take_along_axis(taus, i, axis=1)[:, 0]
    return r, c, np.where(np.isfinite(t), t, INVALID_CYCLES).astype(np.int64)


def _square_rc(xp, D1, D2, Tser, budget):
    """Batched 'square' mode: R = C = floor(sqrt(budget)), fold-tightened."""
    side = xp.maximum(xp.floor(xp.sqrt(budget)).astype(xp.int64), 1)
    r = xp.minimum(side, -(-D1 // (-(-D1 // side))))
    c = xp.minimum(side, -(-D2 // (-(-D2 // side))))
    t = (2 * r + c + Tser - 2) * (-(-D1 // r)) * (-(-D2 // c))
    return r, c, t


def optimize_rc_batched(
    M, K, N, n_macs, tiers, dataflow: str = "dos", mode: OptMode = "opt",
    backend: str = "numpy", device=None,
):
    """Batched array-shape optimizer over whole design grids.

    Broadcasts ``M, K, N, n_macs, tiers`` against each other, derives the
    per-tier budget ``n_macs // tiers`` (the paper rounds down "to avoid
    resource over-provision", Sec. IV-A), and returns ``(rows, cols,
    cycles)`` int64 arrays of the broadcast shape. Design points whose
    per-tier budget is < 1 get ``cycles == INVALID_CYCLES``.

    Delegates to the engine's chunked/table-factored search — the one
    implementation behind the scalar optimizers, ``evaluate()`` and
    this function alike. ``backend`` selects numpy or the torch search
    on ``device`` (``None``: the card; see ``engine.evaluate``).
    """
    from .engine import _DEFAULT_CHUNK, _optimize_flat, _search_device  # lazy: engine imports us

    M, K, N, n_macs, L = np.broadcast_arrays(
        *(np.asarray(x, dtype=np.int64) for x in (M, K, N, n_macs, tiers))
    )
    shape = M.shape
    flat = [np.ascontiguousarray(x.reshape(-1)) for x in (M, K, N, n_macs, L)]
    r, c, t = _optimize_flat(*flat, dataflow, mode, backend, _DEFAULT_CHUNK,
                             device=_search_device(backend, device))
    return r.reshape(shape), c.reshape(shape), t.reshape(shape)


def _best_rc(M, K, N, budget, tiers, mode: OptMode):
    """Find (R, C) minimizing Eq. 2 for a per-tier MAC budget.

    ``mode='square'`` reproduces the paper's plotted configurations
    (square tiers, R = C = floor(sqrt(budget))); ``mode='opt'`` searches
    all useful rectangular shapes with R*C <= budget. Rows beyond M and
    columns beyond N are never useful (they only add fill/drain time),
    so the search space is R in [1, min(M, budget)].

    Thin scalar wrapper over the batched kernel (batch of one) — the
    batched path IS the implementation.
    """
    budget = int(budget)
    if budget < 1:
        raise ValueError(f"per-tier MAC budget must be >= 1, got {budget}")
    D1, D2, Tser = dataflow_dims(
        "dos", np.array([M]), np.array([K]), np.array([N]), np.array([tiers])
    )
    b = np.array([budget], dtype=np.int64)
    if mode == "square":
        r, c, t = _square_rc(np, D1, D2, Tser, b)
    else:
        r, c, t = _search_rc(np, D1, D2, Tser, b, int(min(int(M), budget)))
    return int(r[0]), int(c[0]), float(t[0])


def optimize_array_2d(M, K, N, n_macs, mode: OptMode = "opt") -> ArrayPlan:
    """Paper's [13] methodology: best (R, C) for a 2D array budget."""
    r, c, t = _best_rc(M, K, N, n_macs, 1, mode)
    return ArrayPlan(
        rows=r, cols=c, tiers=1, cycles=t, n_macs_used=r * c,
        workload_macs=int(M) * int(K) * int(N),
    )


def optimize_array_3d(M, K, N, n_macs, tiers, mode: OptMode = "opt") -> ArrayPlan:
    """Best per-tier (R', C') for a 3D array: budget floor(n_macs/tiers).

    The paper rounds the per-tier budget down "to avoid resource
    over-provision" (Sec. IV-A).
    """
    tiers = int(tiers)
    per_tier = int(n_macs) // tiers
    r, c, t = _best_rc(M, K, N, per_tier, tiers, mode)
    return ArrayPlan(
        rows=r, cols=c, tiers=tiers, cycles=t, n_macs_used=tiers * r * c,
        workload_macs=int(M) * int(K) * int(N),
    )


def speedup_3d(M, K, N, n_macs, tiers, mode: OptMode = "opt") -> float:
    """Speedup of the optimized 3D array over the optimized 2D array
    with the same MAC budget (the y-axis of Figs. 5 and 6)."""
    t2 = optimize_array_2d(M, K, N, n_macs, mode).cycles
    t3 = optimize_array_3d(M, K, N, n_macs, tiers, mode).cycles
    return float(t2 / t3)


def optimal_tiers(M, K, N, n_macs, max_tiers: int = 16, mode: OptMode = "opt"):
    """argmin over tier count of the optimized 3D runtime (Fig. 7)."""
    best_l, best_t = 1, np.inf
    for l in range(1, int(max_tiers) + 1):
        if n_macs // l < 1:
            break
        t = optimize_array_3d(M, K, N, n_macs, l, mode).cycles
        if t < best_t:
            best_l, best_t = l, t
    return best_l, best_t


def mac_threshold(M, N) -> int:
    """N_min — minimum MAC budget for 3D to outperform 2D (Sec. IV-A.1).

    The paper finds 3D pays off only once the array can hold the whole
    M x N output spatially: ``N_macs > M*N``.
    """
    return int(M) * int(N)
