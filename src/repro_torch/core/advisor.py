"""Dataflow advisor: the paper's DSE, extended from tiers to TPU meshes.

A numpy copy of the JAX package's ``core/advisor.py``: the mesh it
advises on is the reference's TPU model (``ppa.constants``), not the
card the port runs on.

The paper asks: *given a GEMM (M, K, N) and a MAC budget, how many tiers
ℓ should the 3D array have, and does the (ℓ-1)-cycle cross-tier
reduction pay for itself?* (Eq. 2, Figs. 5-7).

On a TPU mesh the same question becomes: *given a GEMM and a mesh axis
of size ℓ, which operand dimension do we shard over the axis — and is
the resulting collective worth it?* The mapping is exact:

  - sharding K over the axis == the paper's dOS: each device holds a
    K/ℓ slice, computes a partial M x N sum, and the cross-tier adder
    pile becomes an **all-reduce of the M x N output** (cost grows with
    ℓ like the paper's ℓ-1 term — same convexity, same optimum).
  - sharding N (or M) over the axis == WS/IS-in-3D == model/data
    parallelism: no partial sums, but each device must see the whole A
    (all-gather of the activations) — the paper's "scaled-out 2D".

The advisor scores each strategy with a roofline-style cost model
(compute + memory + collective terms, using the v5e constants) and
returns the winner. The paper's threshold ``N_macs > M*N`` reappears
naturally: K-sharding wins when the per-device output tile M*N is too
small to fill the device (e.g. decode GEMMs) and K is large.

The scoring itself lives in the batched evaluation engine
(``core.engine.score_mesh_strategies``): ``rank_candidates`` costs a
whole batch of GEMMs x all four strategies in one vectorized engine
call, and the scalar ``score_strategies``/``choose_sharding`` are its
batch-of-one wrappers.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .engine import ICI_HOP_LATENCY_S, MESH_STRATEGIES, score_mesh_strategies
from .ppa import constants as C

__all__ = [
    "GemmShard",
    "score_strategies",
    "choose_sharding",
    "rank_candidates",
    "Strategy",
]

_BF16 = 2  # bytes


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str  # 'replicate' | 'shard_M' | 'shard_N' | 'shard_K' (dOS)
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def total_s(self) -> float:
        # Compute and memory overlap on TPU (different units); the
        # collective is serialized unless overlapped — we model the
        # pessimistic (paper-faithful: sequential adder pile) case.
        return max(self.compute_s, self.memory_s) + self.collective_s


@dataclasses.dataclass(frozen=True)
class GemmShard:
    M: int
    K: int
    N: int
    axis: int  # mesh axis size (the paper's tier count ℓ)
    bytes_per_el: int = _BF16

    def flops(self) -> float:
        return 2.0 * self.M * self.K * self.N


def score_strategies(
    g: GemmShard,
    flops_per_s: float = C.TPU_PEAK_FLOPS_BF16,
    hbm_bw: float = C.TPU_HBM_BW,
    ici_bw: float = C.TPU_ICI_BW_PER_LINK,
    mxu_tile: int = 128,
) -> list[Strategy]:
    """Cost each way of mapping the GEMM onto one mesh axis of size ℓ.

    Batch-of-one wrapper over the engine's vectorized scoring
    (``core.engine.score_mesh_strategies``); see there for the model.
    """
    scores = score_mesh_strategies(
        g.M, g.K, g.N, g.axis,
        bytes_per_el=g.bytes_per_el,
        flops_per_s=flops_per_s,
        hbm_bw=hbm_bw,
        ici_bw=ici_bw,
        mxu_tile=mxu_tile,
    )
    return [
        Strategy(
            name,
            float(np.asarray(scores[name]["compute_s"]).reshape(-1)[0]),
            float(np.asarray(scores[name]["memory_s"]).reshape(-1)[0]),
            float(np.asarray(scores[name]["collective_s"]).reshape(-1)[0]),
        )
        for name in MESH_STRATEGIES
    ]


def _rank(
    workloads,
    axis,
    mac_budget: int | None = None,
    tech: str = "tsv",
    thermal_limit: float | None = None,
    **kw,
):
    """The ranking engine behind ``rank_candidates`` and the Study
    ``'advise'`` analysis — both route through this one implementation,
    so the shim and the spec path can never drift.

    ``workloads`` is an (n, 3) array-like of (M, K, N) rows; ``axis`` is
    the mesh-axis size (scalar or (n,)). Returns ``(names, totals)``:
    ``names`` — (n,) array of winning strategy names, ``totals`` — (n,
     4) float64 of total seconds per strategy, columns ordered as
    ``engine.MESH_STRATEGIES``.

    When ``mac_budget`` is given, thermal feasibility becomes a
    first-class constraint: ``shard_K`` is the paper's dOS — the
    physically 3D-stacked mapping with ``axis`` tiers — so workloads
    whose ``axis``-tier stack at that MAC budget would exceed
    ``thermal_limit`` (default: the junction budget) get ``shard_K``
    struck from the ranking (total = inf) and fall back to the best
    scaled-out-2D strategy. The other three strategies replicate or
    shard without stacking and are never thermally masked.
    """
    wl = np.atleast_2d(np.asarray(workloads, dtype=np.int64))
    scores = score_mesh_strategies(wl[:, 0], wl[:, 1], wl[:, 2], axis, **kw)
    totals = np.stack(
        [np.broadcast_to(scores[n]["total_s"], (wl.shape[0],)) for n in MESH_STRATEGIES],
        axis=1,
    )
    if mac_budget is not None:
        from .engine import thermal_feasible

        limit = C.THERMAL_BUDGET_C if thermal_limit is None else thermal_limit
        feas = thermal_feasible(
            wl, [int(mac_budget)], axis, tech=tech, thermal_limit=limit
        )[:, 0]
        totals = totals.copy()
        totals[~feas, MESH_STRATEGIES.index("shard_K")] = np.inf
    names = np.asarray(MESH_STRATEGIES)[np.argmin(totals, axis=1)]
    return names, totals


def rank_candidates(
    workloads,
    axis,
    mac_budget: int | None = None,
    tech: str = "tsv",
    thermal_limit: float | None = None,
    **kw,
):
    """DEPRECATED shim: rank all four mesh strategies for a batch of
    GEMMs. Build the declarative equivalent instead —

        Study(workload=WorkloadSpec(kind='gemms', gemms=...),
              space=SpaceSpec(tech=...),
              constraints=ConstraintSpec(thermal_limit_c=...),
              analysis=AnalysisSpec(kind='advise', axis=..., mac_budget=...))

    — whose ``run()`` payload carries the same ``names``/``totals``
    (see ``_rank`` for semantics; both paths share it bit-for-bit).
    """
    import warnings

    from .ppa import constants as _C
    from .study import AnalysisSpec, ConstraintSpec, SpaceSpec, Study, WorkloadSpec

    warnings.warn(
        "rank_candidates(...) is deprecated; use a core.study.Study with "
        "AnalysisSpec(kind='advise') — same engine, same bits, plus a "
        "serializable StudyResult artifact.",
        DeprecationWarning,
        stacklevel=2,
    )
    wl = np.atleast_2d(np.asarray(workloads, dtype=np.int64))
    axis_arr = np.atleast_1d(np.asarray(axis))
    if axis_arr.shape[0] != 1:
        # per-workload axis sizes never fit one scalar spec field; rank
        # directly (identical implementation, no artifact).
        return _rank(wl, axis, mac_budget=mac_budget, tech=tech,
                     thermal_limit=thermal_limit, **kw)
    res = Study(
        workload=WorkloadSpec(kind="gemms", gemms=tuple(map(tuple, wl.tolist()))),
        space=SpaceSpec(tech=tech),
        constraints=ConstraintSpec(
            thermal_limit_c=_C.THERMAL_BUDGET_C if thermal_limit is None
            else thermal_limit
        ),
        analysis=AnalysisSpec(kind="advise", axis=int(axis_arr[0]),
                              mac_budget=mac_budget, params=dict(kw)),
    ).run()
    return res.payload["names"], res.payload["totals"]


def choose_sharding(g: GemmShard, **kw) -> Strategy:
    """The advisor: minimum-total-time strategy for this GEMM."""
    return min(score_strategies(g, **kw), key=lambda s: s.total_s)


def advise_layer(M: int, K: int, N: int, axis: int, **kw) -> str:
    return choose_sharding(GemmShard(M=M, K=K, N=N, axis=axis), **kw).name


# ---------------------------------------------------------------------------
# Chain-aware scoring (§Perf B3 lesson)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChainStrategy:
    name: str
    compute_s: float
    collective_s: float
    reshard_s: float

    @property
    def total_s(self) -> float:
        return self.compute_s + self.collective_s + self.reshard_s


def score_block_chain(
    tokens: int,
    d_model: int,
    d_ff: int,
    n_heads: int,
    head_dim: int,
    axis: int,
    flops_per_s: float = C.TPU_PEAK_FLOPS_BF16,
    ici_bw: float = C.TPU_ICI_BW_PER_LINK,
) -> list[ChainStrategy]:
    """Whole-transformer-block comparison of dOS vs megatron vs zero.

    The single-GEMM model (score_strategies) misses that a *chain* of
    GEMMs pays a resharding boundary wherever consecutive GEMMs want
    different input layouts. This is the §Perf B3 lesson: per-GEMM, dOS
    (shard_K) scores best for decode GEMMs, but megatron's col->row
    pairing runs the whole attention + MLP chain with ONE collective per
    pair, while pure dOS pays a reduce-scatter after EVERY GEMM plus
    latency hops. Counts per block (fwd):

      dOS:       6 GEMMs -> 6 reduce-scatters of each output + hops
      megatron:  2 collectives (attn out AR, mlp out AR)
      zero:      0 activation collectives; weight all-gathers instead
    """
    b = 2.0
    L = axis
    e, f, hd2 = d_model, d_ff, n_heads * head_dim
    gemm_flops = 2.0 * tokens * (e * hd2 * 2 + e * hd2 + hd2 * e) + 2.0 * tokens * (
        2 * e * f + f * e
    )
    compute = gemm_flops / (L * flops_per_s)
    hop = ICI_HOP_LATENCY_S

    def ar(nbytes):
        return 2.0 * (L - 1) / L * nbytes / ici_bw + 2 * (L - 1) * hop

    def rs(nbytes):
        return (L - 1) / L * nbytes / ici_bw + (L - 1) * hop

    out: list[ChainStrategy] = []
    # dOS: RS after each of ~6 GEMM outputs (sizes: qkv ~2*e+..., o, 2f, e)
    dos_coll = (
        rs(tokens * hd2 * 2 * b) + rs(tokens * e * b)  # qkv + o
        + 2 * rs(tokens * f * b) + rs(tokens * e * b)  # mlp up/gate + down
        + rs(tokens * e * b)  # attention-internal regroup
    )
    out.append(ChainStrategy("dos", compute, dos_coll, 0.0))
    # megatron: one AR per pair (attention out, mlp out)
    meg_coll = 2 * ar(tokens * e * b)
    out.append(ChainStrategy("megatron", compute, meg_coll, 0.0))
    # zero: weight all-gathers amortized across the batch's tokens
    w_bytes = (e * hd2 * 2 + hd2 * e + 3 * e * f) * b
    zero_coll = (L - 1) / L * w_bytes / ici_bw + (L - 1) * hop
    out.append(ChainStrategy("zero", gemm_flops / (L * flops_per_s), zero_coll, 0.0))
    return out


def choose_block_strategy(tokens, d_model, d_ff, n_heads, head_dim, axis, **kw):
    return min(
        score_block_chain(tokens, d_model, d_ff, n_heads, head_dim, axis, **kw),
        key=lambda s: s.total_s,
    )
