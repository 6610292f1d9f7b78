"""Dataflow descriptors for 2D/3D systolic arrays (paper Sec. III-C).

The paper discusses four dataflows for mapping a GEMM ``A(MxK) @ B(KxN)``
onto a systolic array:

- OS  (output stationary):  M,N spatial; K temporal. Outputs accumulate
  in-place; A streams from the left, B from the top.
- WS  (weight stationary):  N,K spatial; M temporal. B pre-loaded.
- IS  (input stationary):   M,K spatial; N temporal. A pre-loaded.
- dOS (distributed output stationary, the paper's contribution): M,N
  spatial in-tier, **K spatial across tiers** (K/l per tier) plus an
  (l-1)-cycle cross-tier accumulation. WS/IS extended to 3D need no
  inter-tier traffic (they degenerate to model parallelism), which is
  why the paper focuses on dOS.

Besides the mapping descriptors, this module derives the *switching
activities* of MACs, horizontal links and vertical (TSV/MIV) links that
the dynamic power model (core.ppa.power) consumes — the paper found a
static analysis insufficient precisely because these activities differ
between the horizontal and vertical links (Sec. IV-B).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .analytical import _ceil_div, fold_dims, native_fold, tau_is, tau_ws

__all__ = [
    "Dataflow",
    "OS",
    "WS",
    "IS",
    "DOS",
    "DATAFLOWS",
    "Activity",
    "dos_activity",
    "activity_batched",
]


@dataclasses.dataclass(frozen=True)
class Dataflow:
    name: str
    spatial: tuple  # GEMM dims mapped onto array axes (in-tier)
    temporal: tuple  # GEMM dims mapped onto time
    tier_dim: str | None  # GEMM dim mapped across tiers (3D only)
    stationary: str  # which operand (or 'output') stays in place
    cross_tier_traffic: bool  # does the 3D variant need vertical links?

    def describe(self) -> str:
        t = f", {self.tier_dim} across tiers" if self.tier_dim else ""
        return (
            f"{self.name}: {'/'.join(self.spatial)} spatial, "
            f"{'/'.join(self.temporal)} temporal{t}; {self.stationary} stationary"
        )


OS = Dataflow("OS", ("M", "N"), ("K",), None, "output", False)
WS = Dataflow("WS", ("N", "K"), ("M",), None, "B", False)
IS = Dataflow("IS", ("M", "K"), ("N",), None, "A", False)
#: The paper's contribution: K split across tiers with cross-tier reduction.
DOS = Dataflow("dOS", ("M", "N"), ("K/l",), "K", "output", True)

#: Engine-facing registry: lower-case key -> descriptor.
DATAFLOWS = {"os": OS, "ws": WS, "is": IS, "dos": DOS}


@dataclasses.dataclass(frozen=True)
class Activity:
    """Average switching activities over a workload's runtime.

    All activities are per-unit-per-cycle event rates in [0, 1]:
    ``mac`` — fraction of MACs doing useful work in an average cycle;
    ``hlink`` — word-transfers per horizontal link per cycle;
    ``vlink`` — word-transfers per vertical (TSV/MIV) link per cycle;
    ``cycles`` — total runtime (denominator).
    """

    mac: float
    hlink: float
    vlink: float
    cycles: float
    hlink_hops_total: float
    vlink_hops_total: float
    mac_ops_total: float


def activity_batched(M, K, N, R, C, tiers, dataflow: str = "dos",
                     fold: str | None = None) -> Activity:
    """Batched activity factors for one dataflow over arrays of designs.

    All arguments broadcast; the returned ``Activity`` carries float64
    arrays of the broadcast shape (the scalar ``dos_activity`` is the
    batch-of-one special case). Derivation for dOS (per fold of full
    tiles, averaged over all folds):

    - MAC-ops: every output element needs K multiply-accumulates, spread
      over ``l`` tiers; per fold the tile does R*C*ceil(K/l) ops *per
      tier*.
    - Horizontal hops: an element of A traverses up to C PEs rightward,
      an element of B traverses up to R PEs downward (in-plane). Every
      useful MAC-op implies one A-hop and one B-hop arriving at that PE,
      so in-plane word-hops ~= 2 * mac_ops over ~2*R*C*l links.
    - Vertical hops: only the partial-sum accumulation uses the TSV/MIV
      pile: each of the R*C piles moves one word across each of its
      (l-1) interfaces per fold -> R*C*(l-1) word-hops over R*C*(l-1)
      vertical links => per-link activity 1/tau_fold. This is the
      asymmetry that makes the paper's dynamic power analysis matter.

    WS and IS keep the same operand-delivery hop model (2 hops per
    useful MAC) but have **zero** vertical activity: extended to 3D they
    split their temporal dimension across tiers with no cross-tier
    traffic (Sec. III-C), which is why the paper focuses on dOS.

    ``fold`` selects a non-native tier fold (``analytical.fold_dims``):
    cycles come from the fold's (D1, D2, T) triple; vertical hops are a
    dOS-style R*C*(L-1) plane per fold when the contraction dim is
    split, or the shared operand's compulsory multicast — (L-1) copies
    of its K*N (fold-m) / M*K (fold-n) words — when an output dim is.
    The fold's in-plane delivery keeps the generic 2-hops-per-MAC
    model. ``fold=None`` or the dataflow's native fold is the existing
    model, bit-for-bit.
    """
    M, K, N, R, C, L = np.broadcast_arrays(
        *(np.asarray(x, dtype=np.int64) for x in (M, K, N, R, C, tiers))
    )
    if fold is not None and fold != native_fold(dataflow):
        D1, D2, Tser = fold_dims(fold, dataflow, M, K, N, L)
        folds = _ceil_div(D1, R) * _ceil_div(D2, C)
        cycles = ((2 * R + C + Tser - 2) * folds).astype(np.float64)
        if fold == "k":  # ws/is contraction split: partial-sum planes
            v_hops = np.where(L > 1, R * C * (L - 1) * folds, 0).astype(np.float64)
        else:  # output-dim split: multicast the shared operand once
            shared_words = K * N if fold == "m" else M * K
            v_hops = np.where(L > 1, (L - 1) * shared_words, 0).astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            v_act = np.where(
                L > 1, v_hops / (cycles * R * C * np.maximum(L - 1, 1)), 0.0
            )
    elif dataflow in ("os", "dos"):
        kl = _ceil_div(K, L)
        folds = _ceil_div(M, R) * _ceil_div(N, C)
        tau_fold = 2 * R + C + kl + L - 3  # == 2R + C + K - 2 at l = 1
        cycles = (tau_fold * folds).astype(np.float64)
        v_hops = np.where(L > 1, R * C * (L - 1) * folds, 0).astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            v_act = np.where(
                L > 1, v_hops / (cycles * R * C * np.maximum(L - 1, 1)), 0.0
            )
    elif dataflow == "ws":
        cycles = tau_ws(M, K, N, R, C, L).astype(np.float64)
        v_hops = np.zeros_like(cycles)
        v_act = np.zeros_like(cycles)
    elif dataflow == "is":
        cycles = tau_is(M, K, N, R, C, L).astype(np.float64)
        v_hops = np.zeros_like(cycles)
        v_act = np.zeros_like(cycles)
    else:
        raise ValueError(f"unknown dataflow {dataflow!r}")

    # Useful ops honour ragged edges (average active tile = M*N/folds).
    mac_ops = (M * N * K).astype(np.float64)  # total useful MACs across tiers
    mac_act = mac_ops / (cycles * R * C * L)
    h_hops = 2.0 * mac_ops
    n_hlinks = 2.0 * R * C * L
    h_act = h_hops / (cycles * n_hlinks)

    return Activity(
        mac=mac_act,
        hlink=h_act,
        vlink=v_act,
        cycles=cycles,
        hlink_hops_total=h_hops,
        vlink_hops_total=v_hops,
        mac_ops_total=mac_ops,
    )


def dos_activity(M, K, N, R, C, tiers) -> Activity:
    """Scalar dOS activity factors (batch-of-one of ``activity_batched``).

    For tiers == 1 this is plain OS on a 2D array.
    """
    a = activity_batched(
        np.array([M]), np.array([K]), np.array([N]),
        np.array([R]), np.array([C]), np.array([tiers]), "dos",
    )
    return Activity(*(float(np.asarray(f)[0]) for f in dataclasses.astuple(a)))
