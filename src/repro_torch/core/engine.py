"""Unified batched design-space evaluation engine (perf + PPA sweeps).

The paper's headline results (Figs. 5-7, 9; up to 9.14x 3D-vs-2D
speedup) come from sweeping thousands of (workload x array x tier)
design points through the runtime, power and thermal models. This
module evaluates such sweeps in **one vectorized pass**:

    grid = DesignGrid.product(
        workloads=[(64, 12100, 147)],          # (M, K, N) rows
        mac_budgets=[2**14, 2**16, 2**18],
        tiers=range(1, 17),
    )
    res = evaluate(grid)                       # every metric, (W, P) arrays
    res.speedup, res.power_w, res.t_max_c, ...

For every (workload, design point) pair the engine finds the optimal
per-tier (R, C) under the MAC budget (or takes explicit rows/cols),
then derives in one shot: cycles (Eq. 1/2 and the WS/IS analogues),
switching activities, silicon area, dynamic+static power, energy,
steady-state tier temperatures (lumped model), utilization, and the
3D-vs-2D speedup against the budget-matched optimized 2D baseline.

Backends: ``backend='numpy'`` (default) runs the batched search with
numpy; ``backend='torch'`` runs the same search
(``analytical._search_rc_torch``) on int64 tensors on a torch device,
the card unless the caller names another (cycle counts overflow
int32). Both return identical integers; derived metrics are always
finished in numpy so the two backends share every formula downstream
of the search.

The scalar optimizers in ``core.analytical`` are batch-of-one wrappers
over the same kernel, so per-point and grid results can never drift —
the regression tests pin ``fig5_sweep``/``fig6_sweep``/``fig7_scatter``
to the legacy loop implementations bit-for-bit.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device
from .analytical import (
    FOLD_NAMES,
    INVALID_CYCLES,
    _search_rc,
    _search_rc_torch,
    _square_rc,
    fold_dims,
    native_fold,
)
from .bandwidth import (
    BOUND_NAMES,
    BandwidthSpec,
    bound_names,
    fold_traffic_batched,
    gemm_traffic_batched,
    roofline_cycles,
)
from .dataflow import activity_batched
from .params import (
    VALID_BACKENDS,
    VALID_DATAFLOWS,
    VALID_FOLDS,
    VALID_METRICS,
    VALID_MODES,
    VALID_SCHEDULE_POLICIES,
    VALID_TECHS,
    VALID_THERMAL_MODES,
    validate_option,
    validate_options,
)
from .ppa import constants as C
from .ppa.area import array_area_um2_batched
from .ppa.power import array_power_batched
from .ppa.thermal import ThermalState, lumped_tier_temps, step_temps
from .pricing import (
    DvfsSpec,
    dram_bytes_per_cycle,
    governed_run,
    governor_step,
    price_steps,
    scale_power,
)

__all__ = [
    "BandwidthSpec",
    "DesignGrid",
    "DvfsSpec",
    "EvalResult",
    "NetworkReport",
    "PolicyResult",
    "candidate_fixed_designs",
    "evaluate",
    "schedule",
    "thermal_feasible",
    "optimal_tiers_batched",
    "pareto_frontier",
    "pareto_mask_batched",
    "score_mesh_strategies",
    "MESH_STRATEGIES",
    "ICI_HOP_LATENCY_S",
]

_DEFAULT_CHUNK = 2048
_ALL_METRICS = ("perf", "area", "power", "thermal")
#: evaluate() streams point-blocks once the (W, P) result matrix would
#: exceed this many cells — bounds peak memory at any grid size.
_AUTO_STREAM_CELLS = 1 << 22


def _resolve_shards(shard, backend: str, device: torch.device | None) -> int:
    """Shard request -> device count.

    ``'auto'`` is best-effort and portable: it means "all available
    parallelism", the local devices of the search's device type on the
    torch backend (``parallel.shard_eval``) and none (1) on numpy. An
    *explicit* count, by contrast, is a hard request: it errors on the
    numpy backend, and beyond the local devices, rather than silently
    no-opping.
    """
    if shard is None or shard == "none" or shard == 1:
        return 1
    if backend != "torch":
        if shard == "auto":
            return 1
        raise ValueError(
            f"shard={shard!r} requires backend='torch' (the numpy search has "
            "no device axis); use shard='auto' for best-effort portability"
        )
    from ..parallel.shard_eval import resolve_shards

    return resolve_shards(shard, device)


def _search_device(backend: str, device) -> torch.device | None:
    """The torch device of the search: ``None`` means the card, and a
    missing card raises (``backend='torch'`` never runs numpy). The
    numpy backend takes no device."""
    if backend == "torch":
        return resolve_device(device)
    if device is not None:
        raise ValueError(f"device={device!r} applies to backend='torch' only")
    return None


def _as_1d_int(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x, dtype=np.int64))


@dataclasses.dataclass(frozen=True)
class DesignGrid:
    """A batch of GEMM workloads crossed with a batch of design points.

    ``workloads`` is (W, 3) int64 — rows of (M, K, N), the GEMM
    ``A(M x K) @ B(K x N)`` dimensions [elements]. Design points are
    parallel (P,) arrays: either ``mac_budgets`` [MAC units] (the
    engine optimizes the per-tier (R, C) shape under ``mac_budgets //
    tiers``, the paper's Sec. IV-A rounding) or explicit
    ``rows``/``cols`` [MACs per tier edge].
    ``dataflow`` is 'os' | 'ws' | 'is' | 'dos' — one string for the
    whole grid or a (P,) array ('os' is dOS at any tier count's l=1
    formulaic limit; at tiers > 1 'os' is treated as dOS). ``tech`` is
    '2d' | 'tsv' | 'miv', scalar or (P,).

    ``dram_gbs`` / ``sram_kib`` (optional, scalar or (P,) float) make
    the memory system itself a search axis: per-point DRAM bandwidth
    [GB/s] and per-tier SRAM capacity [KiB]. They only take effect when
    ``evaluate()`` runs with a ``BandwidthSpec`` — the per-point values
    override the spec's scalar ``dram_gbs`` / ``sram_kib_per_tier`` —
    and are ignored (with the spec's scalars used grid-wide) otherwise.

    ``fold`` (optional, 'm' | 'k' | 'n', scalar or (P,)) makes the
    per-layer tier fold a design axis (``analytical.fold_dims``): which
    GEMM dimension the l tiers partition. ``None`` (default) is the
    dataflow's native fold everywhere — the paper's tier split,
    bit-identical to the pre-fold engine.
    """

    workloads: np.ndarray
    tiers: np.ndarray
    mac_budgets: np.ndarray | None = None
    rows: np.ndarray | None = None
    cols: np.ndarray | None = None
    dataflow: str | np.ndarray = "dos"
    tech: str | np.ndarray = "tsv"
    mode: str = "opt"
    dram_gbs: np.ndarray | None = None
    sram_kib: np.ndarray | None = None
    fold: str | np.ndarray | None = None

    def __post_init__(self):
        validate_options("dataflow", self.dataflow, VALID_DATAFLOWS)
        validate_options("tech", self.tech, VALID_TECHS)
        validate_option("mode", self.mode, VALID_MODES)
        if self.fold is not None:
            validate_options("fold", self.fold, VALID_FOLDS)
        wl = np.atleast_2d(np.asarray(self.workloads, dtype=np.int64))
        if wl.ndim != 2 or wl.shape[1] != 3:
            raise ValueError(f"workloads must be (W, 3) of (M, K, N), got {wl.shape}")
        object.__setattr__(self, "workloads", wl)
        if self.mac_budgets is None and (self.rows is None or self.cols is None):
            raise ValueError("need either mac_budgets or explicit rows+cols")
        # The point count P is the common broadcast length of every
        # per-point field, so e.g. scalar tiers + vector budgets works.
        per_point = {"tiers": _as_1d_int(self.tiers)}
        for name in ("mac_budgets", "rows", "cols"):
            v = getattr(self, name)
            if v is not None:
                per_point[name] = _as_1d_int(v)
        for name in ("dram_gbs", "sram_kib"):
            v = getattr(self, name)
            if v is not None:
                arr = np.atleast_1d(np.asarray(v, dtype=np.float64))
                if not np.all(arr > 0):
                    raise ValueError(f"{name} values must be > 0")
                per_point[name] = arr
        for name in ("dataflow", "tech", "fold"):
            v = getattr(self, name)
            if v is not None and not isinstance(v, str):
                per_point[name] = np.atleast_1d(np.asarray(v))
        try:
            P = np.broadcast_shapes(*(a.shape for a in per_point.values()))[0]
        except ValueError:
            lens = {k: a.shape[0] for k, a in per_point.items()}
            raise ValueError(
                f"design-point arrays have incompatible lengths: {lens}"
            ) from None
        for name, v in per_point.items():
            object.__setattr__(self, name, np.broadcast_to(v, (P,)))

    @property
    def n_workloads(self) -> int:
        return self.workloads.shape[0]

    @property
    def n_points(self) -> int:
        return self.tiers.shape[0]

    @classmethod
    def product(
        cls,
        workloads,
        mac_budgets: Sequence[int],
        tiers: Sequence[int],
        **kw,
    ) -> "DesignGrid":
        """Cartesian product of budgets x tiers (budget-major ordering:
        point index p = i_budget * len(tiers) + i_tier)."""
        b = _as_1d_int(mac_budgets)
        t = _as_1d_int(tiers)
        bb = np.repeat(b, t.shape[0])
        tt = np.tile(t, b.shape[0])
        return cls(workloads=workloads, tiers=tt, mac_budgets=bb, **kw)

    @classmethod
    def explicit(cls, workloads, rows, cols, tiers, **kw) -> "DesignGrid":
        """Design points with fixed per-tier (rows, cols) — no search."""
        return cls(workloads=workloads, tiers=tiers, rows=rows, cols=cols, **kw)

    def subset(self, lo: int, hi: int) -> "DesignGrid":
        """The sub-grid of design points [lo, hi) (same workloads).

        The engine's search is rowwise independent, so evaluating a
        subset and slicing the full evaluation give identical bits —
        this is what makes streaming and chunk caching exact.
        """
        kw: dict = {"workloads": self.workloads, "tiers": self.tiers[lo:hi],
                    "mode": self.mode}
        for name in ("mac_budgets", "rows", "cols", "dram_gbs", "sram_kib"):
            v = getattr(self, name)
            if v is not None:
                kw[name] = v[lo:hi]
        for name in ("dataflow", "tech", "fold"):
            v = getattr(self, name)
            if name == "fold" and v is None:
                continue
            kw[name] = v if isinstance(v, str) else v[lo:hi]
        return DesignGrid(**kw)

    def to_dict(self) -> dict:
        """JSON-compatible form; ``from_dict`` is the exact inverse."""
        out: dict = {"workloads": self.workloads.tolist()}
        for name in ("tiers", "mac_budgets", "rows", "cols", "dram_gbs", "sram_kib"):
            v = getattr(self, name)
            out[name] = None if v is None else np.asarray(v).tolist()
        for name in ("dataflow", "tech", "fold"):
            v = getattr(self, name)
            if name == "fold" and v is None:
                out[name] = None
                continue
            out[name] = v if isinstance(v, str) else [str(x) for x in v]
        out["mode"] = self.mode
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "DesignGrid":
        kw = {"workloads": d["workloads"], "tiers": d["tiers"], "mode": d.get("mode", "opt")}
        for name in ("mac_budgets", "rows", "cols", "dram_gbs", "sram_kib"):
            if d.get(name) is not None:
                kw[name] = d[name]
        for name in ("dataflow", "tech", "fold"):
            v = d.get(name)
            if v is not None:
                kw[name] = v if isinstance(v, str) else np.asarray(v)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class EvalResult:
    """Stacked evaluation results; every array is (W, P) float64/int64.

    Units, per field: ``rows``/``cols`` are per-tier array dimensions
    [MACs]; ``cycles``/``cycles_2d``/``stall_cycles``/``mem_cycles``/
    ``vlink_cycles`` are clock cycles at the model's 1 GHz
    (``ppa.constants.FREQ_HZ``); ``area_um2``/``footprint_um2`` are
    silicon area [um^2]; ``power_w`` family is watts [W]; ``energy_j``
    is joules [J]; ``edp_js`` is the energy-delay product [J*s];
    ``t_max_c`` is the hottest tier's steady-state temperature [degC];
    ``dram_bytes``/``vlink_bytes``/``sram_need_bytes`` are bytes;
    ``speedup``/``utilization``/activity fields are dimensionless.

    ``cycles`` / ``cycles_2d`` are float64 (np.inf marks invalid design
    points, e.g. per-tier budget < 1); ``speedup = cycles_2d / cycles``
    against the budget-matched optimized 2D baseline of the same
    dataflow family. Metric groups not requested from ``evaluate()``
    are None.

    The bandwidth group (``stall_cycles`` ... ``within_sram_capacity``)
    is present iff ``evaluate()`` ran with a ``bandwidth=`` spec; then
    ``cycles``/``cycles_2d`` are the bandwidth-aware roofline totals
    (``cycles = compute + stall_cycles``) and ``bound`` classifies each
    point as ``'compute' | 'memory' | 'vlink'``. With an unbounded spec
    the group is all-zero/'compute' and every other field is bit-for-bit
    identical to the bandwidth-oblivious result.
    """

    grid: DesignGrid
    rows: np.ndarray
    cols: np.ndarray
    cycles: np.ndarray
    cycles_2d: np.ndarray
    speedup: np.ndarray
    utilization: np.ndarray
    valid: np.ndarray
    mac_act: np.ndarray | None = None
    hlink_act: np.ndarray | None = None
    vlink_act: np.ndarray | None = None
    area_um2: np.ndarray | None = None
    footprint_um2: np.ndarray | None = None
    area_norm_speedup: np.ndarray | None = None
    power_w: np.ndarray | None = None
    peak_power_w: np.ndarray | None = None
    static_power_w: np.ndarray | None = None
    dynamic_power_w: np.ndarray | None = None
    energy_j: np.ndarray | None = None
    edp_js: np.ndarray | None = None
    t_max_c: np.ndarray | None = None
    within_thermal_budget: np.ndarray | None = None
    #: bandwidth group — set iff evaluate() ran with a bandwidth spec.
    stall_cycles: np.ndarray | None = None
    bound: np.ndarray | None = None
    mem_cycles: np.ndarray | None = None
    vlink_cycles: np.ndarray | None = None
    dram_bytes: np.ndarray | None = None
    vlink_bytes: np.ndarray | None = None
    sram_need_bytes: np.ndarray | None = None
    within_sram_capacity: np.ndarray | None = None
    #: sustained-performance group — set iff evaluate() ran with
    #: thermal='transient': DVFS-governed steps/s over the settled half
    #: of the run, the cold top-state rate, their ratio, the governed
    #: hottest-tier excursion [degC], and the (W, P, n_states) fraction
    #: of governed steps spent in each DVFS state. In this mode
    #: ``within_thermal_budget`` reflects the governed excursion.
    sustained_per_s: np.ndarray | None = None
    peak_per_s: np.ndarray | None = None
    peak_vs_sustained: np.ndarray | None = None
    t_max_transient_c: np.ndarray | None = None
    dvfs_residency: np.ndarray | None = None

    @property
    def feasible(self) -> np.ndarray:
        """(W, P) bool — valid AND within every evaluated capacity.

        The first-class feasibility mask: optima (``pareto_mask``,
        ``schedule``, the advisor's design ranking) exclude points that
        are structurally invalid, would exceed the junction limit
        [degC], or whose minimal SRAM working set [bytes] does not fit
        the per-tier capacity (bandwidth-aware runs). Masks that were
        not evaluated are skipped.
        """
        m = self.valid
        if self.within_thermal_budget is not None:
            m = m & self.within_thermal_budget
        if self.within_sram_capacity is not None:
            m = m & self.within_sram_capacity
        return m

    #: dtypes restored by ``from_dict`` (everything else is float64).
    _INT_FIELDS = ("rows", "cols")
    _BOOL_FIELDS = ("valid", "within_thermal_budget", "within_sram_capacity")
    _STR_FIELDS = ("bound",)

    def to_dict(self) -> dict:
        """Array fields as a plain dict (None entries dropped), plus the
        originating grid under ``'grid'`` (already JSON-compatible).
        ``from_dict`` completes this into a lossless round-trip."""
        out = {"grid": self.grid.to_dict()}
        for f in dataclasses.fields(self):
            if f.name == "grid":
                continue
            v = getattr(self, f.name)
            if v is not None:
                out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "EvalResult":
        """Inverse of ``to_dict``; accepts arrays or (JSON) nested lists
        and restores the exact per-field dtypes."""
        grid = d["grid"]
        kw = {"grid": grid if isinstance(grid, DesignGrid) else DesignGrid.from_dict(grid)}
        for f in dataclasses.fields(cls):
            if f.name == "grid" or d.get(f.name) is None:
                continue
            if f.name in cls._INT_FIELDS:
                dt = np.int64
            elif f.name in cls._BOOL_FIELDS:
                dt = bool
            elif f.name in cls._STR_FIELDS:
                dt = np.str_
            else:
                dt = np.float64
            kw[f.name] = np.asarray(d[f.name], dtype=dt)
        return cls(**kw)

    @classmethod
    def concat(cls, grid: DesignGrid, parts: Sequence["EvalResult"]) -> "EvalResult":
        """Stitch point-block results back into one (W, P) result.

        ``parts`` are evaluations of consecutive ``grid.subset`` blocks
        (all with the same metric groups); arrays concatenate along the
        point axis. The inverse of streaming: bit-for-bit equal to one
        unstreamed ``evaluate(grid)``.
        """
        if len(parts) == 1:
            return dataclasses.replace(parts[0], grid=grid)
        kw: dict = {"grid": grid}
        for f in dataclasses.fields(cls):
            if f.name == "grid":
                continue
            vs = [getattr(p, f.name) for p in parts]
            kw[f.name] = None if vs[0] is None else np.concatenate(vs, axis=1)
        return cls(**kw)

    def pareto_mask(
        self,
        objectives: Sequence[str] = ("cycles", "area_um2", "power_w"),
        feasible_only: bool = True,
    ) -> np.ndarray:
        """(W, P) bool — per-workload Pareto frontier over the named
        (minimized) metric columns (paper Sec. IV-C/D trade-offs).

        ``feasible_only`` (default) restricts the frontier to
        thermally feasible points: a design that dominates on
        latency/area/power but overshoots the junction limit is not a
        usable optimum. Pass False for the unconstrained frontier.
        """
        cols = []
        for name in objectives:
            v = getattr(self, name)
            if v is None:
                raise ValueError(f"metric {name!r} was not evaluated")
            cols.append(np.asarray(v, dtype=np.float64))
        stacked = np.stack(cols, axis=-1)  # (W, P, n_obj)
        if feasible_only:
            # Infeasible points neither appear on nor dominate the
            # frontier: blank them out before the scan (pareto_frontier
            # ignores non-finite rows entirely).
            stacked = np.where(self.feasible[..., None], stacked, np.inf)
        return pareto_mask_batched(stacked)


# ---------------------------------------------------------------------------
# Search backends
# ---------------------------------------------------------------------------

def _search_batch(D1, D2, Tser, budget, backend: str, chunk: int,
                  device: torch.device | None = None, n_shards: int = 1):
    """Chunked dispatch of the (R, C) search. Returns (r, c, tau) int64
    numpy arrays. ``device`` is the torch backend's (resolved) device;
    ``n_shards`` > 1 splits each chunk across that many local devices of
    its type (``parallel.shard_eval``), bit for bit the same results."""
    B = D1.shape[0]
    r_out = np.empty(B, dtype=np.int64)
    c_out = np.empty(B, dtype=np.int64)
    t_out = np.empty(B, dtype=np.int64)
    if B == 0:
        return r_out, c_out, t_out
    if backend not in VALID_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    # Sort by each point's own search width so every chunk gets a tight
    # r_max — mixing one wide point into a chunk would otherwise charge
    # the whole chunk its width. Pure reordering; results are scattered
    # back, so the output is unchanged.
    widths = np.minimum(D1, budget)
    order = np.argsort(widths, kind="stable")
    if backend == "torch" and n_shards > 1:
        from ..parallel.shard_eval import local_devices, sharded_search

        devices = local_devices(resolve_device(device))[:n_shards]
        step = chunk * n_shards  # ~chunk rows per device
        for lo in range(0, B, step):
            sel = order[lo : lo + step]
            r_out[sel], c_out[sel], t_out[sel] = sharded_search(
                D1[sel], D2[sel], Tser[sel], budget[sel], int(widths[sel[-1]]), n_shards,
                devices)
        return r_out, c_out, t_out
    if backend == "torch":
        # The batch crosses to the device once, sorted; each chunk is
        # searched there and the results come back in one copy.
        device = resolve_device(device)
        args = [
            torch.from_numpy(np.ascontiguousarray(x[order], dtype=np.int64)).to(device)
            for x in (D1, D2, Tser, budget)
        ]
        parts = [
            _search_rc_torch(
                *(a[lo : lo + chunk] for a in args),
                int(widths[order[min(lo + chunk, B) - 1]]),
            )
            for lo in range(0, B, chunk)
        ]
        r, c, t = (torch.cat(x).cpu().numpy() for x in zip(*parts))
        r_out[order], c_out[order], t_out[order] = r, c, t
        return r_out, c_out, t_out
    tables = _factored_tables(D1, D2, budget, int(widths[order[-1]]))
    for lo in range(0, B, chunk):
        sel = order[lo : lo + chunk]
        r_max = int(widths[sel[-1]])
        r = c = t = None
        if tables is not None:
            out = _search_from_tables(tables, sel, Tser, r_max)
            if out is not None:
                r, c, t = out
        if r is None:
            r, c, t = _search_rc(
                np, D1[sel], D2[sel], Tser[sel], budget[sel], r_max
            )
        r_out[sel], c_out[sel], t_out[sel] = r, c, t
    return r_out, c_out, t_out


def _factored_tables(D1, D2, budget, r_max_total: int):
    """Precompute the Tser-independent parts of the (R, C) search.

    Per candidate R the tightened pair only depends on D1 (row folds)
    and on (D2, budget) (column folds): tau = (2*R2 + C2 + Tser - 2) *
    foldM * f. Design grids repeat the same workloads across many tier
    counts/budgets, so computing those chains once per *unique* D1 and
    per unique (D2, budget) pair and gathering rows afterwards removes
    nearly all of the division work. The search-space bound R <=
    min(D1, budget) is baked into the tables as inf entries, so invalid
    candidates cost nothing per chunk. Returns None when the grid has
    too little repetition (or is too wide for exact float64) to pay
    off.
    """
    if r_max_total < 1 or max(
        int(D1.max(initial=0)), int(D2.max(initial=0)), int(budget.max(initial=0))
    ) >= 2**52:
        return None
    uD1, invD1 = np.unique(D1, return_inverse=True)
    pair = np.stack([D2, budget], axis=1)
    upair, invP = np.unique(pair, axis=0, return_inverse=True)
    if (uD1.shape[0] + upair.shape[0]) * 2 > D1.shape[0]:
        return None  # not enough repetition to amortize the tables
    Rf = np.arange(1.0, r_max_total + 1.0)[None, :]
    D1f = uD1.astype(np.float64)[:, None]
    foldM = np.floor((D1f + Rf - 1.0) / Rf)
    R2 = np.floor((D1f + foldM - 1.0) / foldM)  # tightened, same folds
    D2f = upair[:, 0].astype(np.float64)[:, None]
    bf = upair[:, 1].astype(np.float64)[:, None]
    C1 = np.minimum(np.maximum(np.floor(bf / Rf), 1.0), D2f)
    f = np.floor((D2f + C1 - 1.0) / C1)
    C2 = np.floor((D2f + f - 1.0) / f)  # tightened: same folds, smaller C
    # Exact-arithmetic bound pieces: tau <= (fill_base + Tser - 2) *
    # prod_max. Chunks whose bound stays under 2^53 skip any overflow
    # guard (the common case).
    fill_base = 2.0 * R2.max() + C2.max()
    prod_max = foldM.max() * f.max()
    # Bake the R <= D1 / R <= budget pruning in as inf (fill > 0, so
    # inf propagates through tau and argmin never picks these).
    foldM[Rf > D1f] = np.inf
    f[Rf > bf] = np.inf
    # Table entries < 2^23 are exact in float32 — halves the gather
    # bandwidth of the chunk stage; tau itself is still formed in f64.
    dt = (
        np.float32
        if int(uD1.max(initial=0)) < 2**22 and int(upair[:, 0].max(initial=0)) < 2**23
        else np.float64
    )
    return (
        invD1,
        invP,
        foldM.astype(dt),
        (2.0 * R2).astype(dt),
        f.astype(dt),
        C2.astype(dt),
        (fill_base, prod_max),
    )


def _search_from_tables(tables, sel, Tser, r_max: int):
    """Finish the search for one chunk from the factored f64 tables.

    Returns None on (rare) potential tau overflow past 2^53; the caller
    reruns the chunk through the exact int64 kernel.
    """
    invD1, invP, foldM_u, twoR2_u, f_u, C2_u, (fill_base, prod_max) = tables
    Tsf = Tser[sel].astype(np.float64)
    if (fill_base + float(Tsf.max(initial=0.0)) - 2.0) * prod_max >= 2.0**53:
        return None
    g1 = invD1[sel]
    g2 = invP[sel]
    C2 = C2_u[:, :r_max][g2]
    folds = np.multiply(
        foldM_u[:, :r_max][g1], f_u[:, :r_max][g2], dtype=np.float64
    )
    taus = np.add(twoR2_u[:, :r_max][g1], C2, dtype=np.float64)
    taus += (Tsf - 2.0)[:, None]
    np.multiply(taus, folds, out=taus)
    i = np.argmin(taus, axis=1)
    rows = np.arange(sel.shape[0])
    t = taus[rows, i]
    r = (twoR2_u[g1, i] * 0.5).astype(np.int64)
    c = C2[rows, i].astype(np.int64)
    return r, c, np.where(np.isfinite(t), t, INVALID_CYCLES).astype(np.int64)


def _optimize_flat(M, K, N, n_macs, tiers, dataflow, mode, backend, chunk,
                   fold: str | None = None, device: torch.device | None = None,
                   n_shards: int = 1):
    """Batched shape optimization (flat arrays) honoring invalid budgets.
    ``device`` is the torch backend's; ``None`` there means the card."""
    budget = n_macs // tiers
    ok = budget >= 1
    bsafe = np.maximum(budget, 1)
    D1, D2, Tser = fold_dims(fold, dataflow, M, K, N, tiers)
    if mode == "square":
        r, c, t = _square_rc(np, D1, D2, Tser, bsafe)
    else:
        r, c, t = _search_batch(D1, D2, Tser, bsafe, backend, chunk, device, n_shards)
    t = np.where(ok, t, INVALID_CYCLES)
    return r, c, t


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def evaluate(
    grid: DesignGrid,
    backend: str = "numpy",
    metrics: Sequence[str] = _ALL_METRICS,
    chunk: int = _DEFAULT_CHUNK,
    thermal_limit: float = C.THERMAL_BUDGET_C,
    shard: int | str | None = None,
    stream: int | None = None,
    bandwidth: BandwidthSpec | dict | None = None,
    freq_hz: float = C.FREQ_HZ,
    vdd_v: float = C.VDD,
    thermal: str = "steady",
    dvfs: DvfsSpec | dict | None = None,
    device: str | torch.device | None = None,
) -> EvalResult:
    """Evaluate every (workload, design point) pair of the grid at once.

    ``metrics`` selects result groups: 'perf' (always computed),
    'area', 'power', 'thermal' (thermal implies power implies area).
    ``chunk`` bounds the working-set of the (B, R_max) search
    intermediates; results are independent of it. ``thermal_limit``
    sets the junction temperature [degC] behind
    ``within_thermal_budget`` / ``feasible``.

    ``bandwidth`` (a ``core.bandwidth.BandwidthSpec`` or its dict form)
    turns on the bandwidth-aware runtime model: DRAM traffic [bytes]
    under the SRAM-capacity reuse model, vertical-link (TSV vs MIV)
    service time [cycles], and the overlapped roofline ``cycles =
    max(compute, memory, vlink)`` — with ``stall_cycles``, the
    ``bound`` classification and the SRAM feasibility mask added to
    the result (see ``EvalResult``). The 2D baseline behind
    ``speedup`` is bandwidth-adjusted with the same spec (its own
    searched shape, tech '2d': no vertical links). ``None`` (default)
    and an unbounded spec are bit-for-bit identical to the plain
    evaluation. The (R, C) shape search itself stays compute-optimal —
    stalls are charged to the chosen design, not re-searched.

    ``backend='torch'`` runs the (R, C) search on ``device``: ``None``
    means the card, and raises where there is none; the numpy backend
    takes no device. ``shard``: ``None``/``'none'`` stay on one device;
    ``'auto'`` splits the search over every local device of the search's
    device type, an explicit count over that many (more than there are
    raises ``ValueError``), each shard bit for bit the unsharded search
    (``parallel.shard_eval``).
    ``stream`` caps how many design points are evaluated per pass —
    blocks are evaluated consecutively and stitched with
    ``EvalResult.concat`` so peak memory stays bounded at any grid
    size. By default grids past ~4M result cells stream automatically.
    Neither knob changes a single result bit (the search is rowwise
    independent; regression-pinned); both compose with ``bandwidth``.

    ``freq_hz`` / ``vdd_v`` move the whole evaluation to another
    operating point (``core.pricing`` scaling conventions: memory
    cycles and power follow the clock/supply; compute cycles do not).
    The defaults are the reference point and are bit-for-bit identical
    to the historical fixed-1-GHz results.

    ``thermal='transient'`` (requires the 'thermal' metric group)
    additionally runs the DVFS-governed transient model per design
    point: the per-workload step is executed ``dvfs.sim_steps`` times
    against the lumped RC stack (``ppa.thermal.ThermalState``) with the
    governor (``dvfs``, a ``pricing.DvfsSpec``; defaults to
    ``DvfsSpec()``) throttling on tier over-temperature. The result
    gains the sustained-performance group (``sustained_per_s`` ...
    ``dvfs_residency``) and — the semantic flip —
    ``within_thermal_budget`` becomes "the *governed* excursion stays
    under ``thermal_limit``", so a design the steady-state model
    rejects can be feasible at a lower sustained clock.
    """
    validate_option("backend", backend, VALID_BACKENDS)
    validate_option("thermal", thermal, VALID_THERMAL_MODES)
    metrics = {validate_option("metric", m, VALID_METRICS) for m in metrics}
    if thermal == "transient":
        if "thermal" not in metrics:
            raise ValueError(
                "thermal='transient' needs the 'thermal' metric group"
            )
        if dvfs is None:
            dvfs = DvfsSpec()
        elif not isinstance(dvfs, DvfsSpec):
            dvfs = DvfsSpec.from_dict(dvfs)
    elif dvfs is not None:
        raise ValueError("dvfs requires thermal='transient'")
    if "thermal" in metrics:
        metrics.add("power")
    if "power" in metrics:
        metrics.add("area")
    device = _search_device(backend, device)
    n_shards = _resolve_shards(shard, backend, device)
    if bandwidth is not None and not isinstance(bandwidth, BandwidthSpec):
        bandwidth = BandwidthSpec.from_dict(bandwidth)

    W, P = grid.n_workloads, grid.n_points
    if stream is None:
        block = P if W * P <= _AUTO_STREAM_CELLS else max(
            1, _AUTO_STREAM_CELLS // max(W, 1)
        )
    else:
        block = max(1, int(stream))
    if block < P:
        parts = [
            _evaluate_block(
                grid.subset(lo, min(lo + block, P)), backend, metrics, chunk,
                thermal_limit, device, bandwidth, freq_hz, vdd_v,
                thermal, dvfs, n_shards,
            )
            for lo in range(0, P, block)
        ]
        return EvalResult.concat(grid, parts)
    return _evaluate_block(
        grid, backend, metrics, chunk, thermal_limit, device, bandwidth,
        freq_hz, vdd_v, thermal, dvfs, n_shards,
    )


def _evaluate_block(
    grid: DesignGrid,
    backend: str,
    metrics: set,
    chunk: int,
    thermal_limit: float,
    device: torch.device | None = None,
    bandwidth: BandwidthSpec | None = None,
    freq_hz: float = C.FREQ_HZ,
    vdd_v: float = C.VDD,
    thermal: str = "steady",
    dvfs: DvfsSpec | None = None,
    n_shards: int = 1,
) -> EvalResult:
    """One unstreamed evaluation pass (metrics already resolved)."""
    W, P = grid.n_workloads, grid.n_points
    # Flatten workload-major: flat index = w * P + p  -> reshape to (W, P).
    Mf = np.repeat(grid.workloads[:, 0], P)
    Kf = np.repeat(grid.workloads[:, 1], P)
    Nf = np.repeat(grid.workloads[:, 2], P)
    Lf = np.tile(grid.tiers, W)
    tech_p = (
        np.full(P, grid.tech) if isinstance(grid.tech, str) else grid.tech
    )
    techf = np.tile(tech_p, W)
    if grid.mac_budgets is not None:
        budgetf = np.tile(grid.mac_budgets, W)
    else:
        budgetf = np.tile(grid.rows * grid.cols * grid.tiers, W)

    df_p = (
        np.full(P, grid.dataflow)
        if isinstance(grid.dataflow, str)
        else np.asarray(grid.dataflow)
    )
    dff = np.tile(df_p, W)

    # Group the flat batch by (dataflow, fold): every model below is
    # uniform within a group. With no fold axis the groups are exactly
    # the historical per-dataflow groups (fold=None -> native mapping).
    if grid.fold is None:
        groups = [
            (str(df), None, np.nonzero(dff == df)[0]) for df in np.unique(dff)
        ]
    else:
        fold_p = (
            np.full(P, grid.fold)
            if isinstance(grid.fold, str)
            else np.asarray(grid.fold)
        )
        foldf = np.tile(fold_p, W)
        key = np.char.add(np.char.add(dff.astype("U8"), ":"), foldf.astype("U8"))
        groups = []
        for kk in np.unique(key):
            df, fo = str(kk).split(":")
            groups.append((df, fo, np.nonzero(key == kk)[0]))

    rows = np.empty(W * P, dtype=np.int64)
    cols = np.empty(W * P, dtype=np.int64)
    cyc = np.full(W * P, INVALID_CYCLES, dtype=np.int64)
    cyc2d = np.full(W * P, INVALID_CYCLES, dtype=np.int64)
    rows2d = np.ones(W * P, dtype=np.int64)
    cols2d = np.ones(W * P, dtype=np.int64)

    for df, fo, sel in groups:
        M_, K_, N_, L_, b_ = Mf[sel], Kf[sel], Nf[sel], Lf[sel], budgetf[sel]
        if grid.rows is not None:
            rows[sel] = np.tile(grid.rows, W)[sel]
            cols[sel] = np.tile(grid.cols, W)[sel]
            D1, D2, Tser = fold_dims(fo, df, M_, K_, N_, L_)
            r_, c_ = rows[sel], cols[sel]
            cyc[sel] = (2 * r_ + c_ + Tser - 2) * (-(-D1 // r_)) * (-(-D2 // c_))
        else:
            r_, c_, t_ = _optimize_flat(
                M_, K_, N_, b_, L_, df, grid.mode, backend, chunk,
                fold=fo, device=device, n_shards=n_shards,
            )
            rows[sel], cols[sel], cyc[sel] = r_, c_, t_
        # Budget-matched optimized 2D baseline of the same dataflow
        # family (native mapping: every fold degenerates to it on one
        # tier). Dedupe (workload, budget): within `sel` the baseline
        # is constant across tier counts.
        wkey = np.stack([M_, K_, N_, b_], axis=1)
        uniq, inv = np.unique(wkey, axis=0, return_inverse=True)
        r2, c2, t2 = _optimize_flat(
            uniq[:, 0], uniq[:, 1], uniq[:, 2], uniq[:, 3],
            np.ones(len(uniq), dtype=np.int64), df, grid.mode,
            backend, chunk, device=device, n_shards=n_shards,
        )
        cyc2d[sel] = t2[inv]
        rows2d[sel], cols2d[sel] = r2[inv], c2[inv]

    valid = cyc != INVALID_CYCLES
    cycles = np.where(valid, cyc, 0).astype(np.float64)
    cycles[~valid] = np.inf
    cycles_2d = np.where(cyc2d != INVALID_CYCLES, cyc2d, 0).astype(np.float64)
    cycles_2d[cyc2d == INVALID_CYCLES] = np.inf

    # --- bandwidth-aware roofline (tentpole): DRAM / SRAM / vlink -----
    # Applied to the compute-optimal shapes found above; an unbounded
    # spec yields zero stalls and leaves every downstream value
    # bit-for-bit unchanged (max(compute, 0, 0) == compute; + 0.0 is
    # exact), which is what makes bandwidth=None and an uncapped spec
    # regression-identical.
    bw_fields: dict = {}
    stall_flat = None
    if bandwidth is not None:
        mem_cyc = np.zeros(W * P)
        vl_cyc = np.zeros(W * P)
        dram_b = np.zeros(W * P)
        vl_b = np.zeros(W * P)
        sram_need = np.zeros(W * P)
        mem_cyc2 = np.zeros(W * P)
        # Per-point grid overrides (guided search over memory systems):
        # scalars stay the scalar fast path, bit-identical to before.
        if grid.dram_gbs is not None:
            bpc = np.tile(grid.dram_gbs, W) * 1e9 / freq_hz
        else:
            bpc = dram_bytes_per_cycle(bandwidth, freq_hz)
        if grid.sram_kib is not None:
            sram_cap = np.tile(grid.sram_kib, W) * 1024.0
        else:
            sram_cap = bandwidth.sram_bytes
        tech2d = np.full(W * P, "2d")
        ones = np.ones(W * P, dtype=np.int64)
        for df, fo, sel in groups:
            sram_sel = None if grid.sram_kib is None else sram_cap[sel]
            bpc_sel = bpc if np.isscalar(bpc) else bpc[sel]
            tr = fold_traffic_batched(
                fo, df, Mf[sel], Kf[sel], Nf[sel],
                rows[sel], cols[sel], Lf[sel], techf[sel], bandwidth,
                sram_bytes=sram_sel,
            )
            dram_b[sel] = tr["dram_bytes"]
            vl_b[sel] = tr["vlink_bytes"]
            vl_cyc[sel] = tr["vlink_cycles"]
            sram_need[sel] = tr["sram_need_bytes"]
            mem_cyc[sel] = tr["dram_bytes"] / bpc_sel
            # Budget-matched 2D baseline under the same memory system
            # (its own searched shape; tech '2d' has no vertical links).
            tr2 = gemm_traffic_batched(
                df, Mf[sel], Kf[sel], Nf[sel],
                rows2d[sel], cols2d[sel], ones[sel], tech2d[sel], bandwidth,
                sram_bytes=sram_sel,
            )
            mem_cyc2[sel] = tr2["dram_bytes"] / bpc_sel
        compute_flat = cycles  # pre-roofline array-busy cycles
        cycles, stall_flat, bidx = roofline_cycles(cycles, mem_cyc, vl_cyc)
        stall_flat = np.where(valid, stall_flat, np.nan)
        cycles_2d = np.maximum(cycles_2d, mem_cyc2)
        bw_fields = dict(
            stall_cycles=stall_flat.reshape(W, P),
            bound=bound_names(bidx).reshape(W, P),
            mem_cycles=mem_cyc.reshape(W, P),
            vlink_cycles=vl_cyc.reshape(W, P),
            dram_bytes=dram_b.reshape(W, P),
            vlink_bytes=vl_b.reshape(W, P),
            sram_need_bytes=sram_need.reshape(W, P),
            within_sram_capacity=(sram_need <= sram_cap).reshape(W, P),
        )

    with np.errstate(invalid="ignore", divide="ignore"):
        speedup = np.where(valid, cycles_2d / cycles, np.nan)
        n_used = rows * cols * Lf
        utilization = np.where(
            valid, (Mf * Kf * Nf).astype(np.float64) / (n_used * cycles), np.nan
        )

    res = dict(
        rows=rows.reshape(W, P),
        cols=cols.reshape(W, P),
        cycles=cycles.reshape(W, P),
        cycles_2d=cycles_2d.reshape(W, P),
        speedup=speedup.reshape(W, P),
        utilization=utilization.reshape(W, P),
        valid=valid.reshape(W, P),
        **bw_fields,
    )

    act = None
    if "power" in metrics or "area" in metrics:
        # Activities are cheap; compute per dataflow group.
        mac_a = np.zeros(W * P)
        hl_a = np.zeros(W * P)
        vl_a = np.zeros(W * P)
        for df, fo, sel in groups:
            a = activity_batched(
                Mf[sel], Kf[sel], Nf[sel], rows[sel], cols[sel], Lf[sel], df,
                fold=fo,
            )
            mac_a[sel], hl_a[sel], vl_a[sel] = a.mac, a.hlink, a.vlink
        res.update(
            mac_act=mac_a.reshape(W, P),
            hlink_act=hl_a.reshape(W, P),
            vlink_act=vl_a.reshape(W, P),
        )

    if "area" in metrics:
        # The paper's fixed-budget comparison charges the provisioned
        # array ((budget // l) * l MACs), not just the mapped sub-array.
        prov = (budgetf // Lf) * Lf
        a3, fp3, _ = array_area_um2_batched(prov, Lf, techf)
        a2, _, _ = array_area_um2_batched(budgetf, np.ones_like(Lf), "2d")
        with np.errstate(invalid="ignore", divide="ignore"):
            ans = speedup * (a2 / a3)
        res.update(
            area_um2=a3.reshape(W, P),
            footprint_um2=fp3.reshape(W, P),
            area_norm_speedup=ans.reshape(W, P),
        )

    if "power" in metrics:
        pw = {}
        for df, fo, sel in groups:
            p = array_power_batched(
                Mf[sel], Kf[sel], Nf[sel], rows[sel], cols[sel], Lf[sel],
                techf[sel], df, fold=fo,
            )
            for k, v in p.items():
                pw.setdefault(k, np.zeros(W * P))[sel] = v
        pw_ref = pw  # reference-point power (the transient model rescales)
        pw = scale_power(pw, freq_hz, vdd_v)  # identity at the default point
        t_s = np.where(valid, pw["cycles"] / freq_hz, np.nan)
        energy = pw["total_w"] * t_s
        t_total = t_s
        power_avg = pw["total_w"]
        if stall_flat is not None:
            # Stall cycles burn static power only (the MAC/link activity
            # waits with the array); energy = full power over the
            # compute phase + static power over the stall. Exact when
            # stall == 0: + static * 0.0 adds nothing, preserving the
            # uncapped bit-identity.
            t_stall = np.where(valid, stall_flat, 0.0) / freq_hz
            energy = energy + pw["static_w"] * t_stall
            t_total = t_s + t_stall
            with np.errstate(invalid="ignore", divide="ignore"):
                power_avg = np.where(t_stall > 0, energy / t_total, pw["total_w"])
        res.update(
            power_w=np.where(valid, power_avg, np.nan).reshape(W, P),
            peak_power_w=np.where(valid, pw["peak_w"], np.nan).reshape(W, P),
            static_power_w=np.where(valid, pw["static_w"], np.nan).reshape(W, P),
            dynamic_power_w=np.where(valid, pw["dynamic_w"], np.nan).reshape(W, P),
            energy_j=energy.reshape(W, P),
            edp_js=(energy * t_total).reshape(W, P),
        )

    if "thermal" in metrics:
        # Heat flux from the compute-phase power (full activity), not
        # the stall-averaged power: bandwidth stalls only cool the
        # stack, so masking on the active-phase temperature is the
        # conservative (and uncapped-identical) choice.
        lmax = int(np.max(Lf))
        idx = np.arange(lmax)[None, :]
        alive = idx < Lf[:, None]
        with np.errstate(invalid="ignore"):
            q = np.where(
                alive, (np.where(valid, pw["total_w"], 0.0) / Lf)[:, None], 0.0
            )
        fp_mm2 = res["footprint_um2"].reshape(-1) * 1e-6
        T = lumped_tier_temps(q, fp_mm2, Lf, techf, rows * cols)
        t_max = np.where(valid, np.max(np.where(alive, T, -np.inf), axis=1), np.nan)
        res.update(
            t_max_c=t_max.reshape(W, P),
            within_thermal_budget=(t_max < thermal_limit).reshape(W, P),
        )

        if thermal == "transient":
            # DVFS-governed transient run of each (workload, point)
            # step: compute/vlink cycle counts are clock-invariant,
            # memory cycles rescale with the governed clock, power is
            # rescaled per state from the reference report. Feasibility
            # flips to the governed excursion.
            if stall_flat is not None:
                mem_flat, vl_flat = mem_cyc, vl_cyc
            else:
                compute_flat = cycles
                mem_flat = np.zeros(W * P)
                vl_flat = np.zeros(W * P)
            gov = governed_run(
                compute_flat, mem_flat, vl_flat,
                pw_ref["static_w"], pw_ref["dynamic_w"], valid,
                Lf, techf, fp_mm2, rows * cols,
                dvfs, thermal_limit, freq_hz,
            )
            res.update(
                sustained_per_s=gov["sustained_per_s"].reshape(W, P),
                peak_per_s=gov["peak_per_s"].reshape(W, P),
                peak_vs_sustained=gov["peak_vs_sustained"].reshape(W, P),
                t_max_transient_c=gov["t_max_transient_c"].reshape(W, P),
                dvfs_residency=gov["residency"].reshape(W, P, dvfs.n_states),
                within_thermal_budget=gov["within_limit"].reshape(W, P),
            )

    return EvalResult(grid=grid, **res)


def optimal_tiers_batched(
    workloads,
    mac_budgets,
    max_tiers: int = 16,
    mode: str = "opt",
    backend: str = "numpy",
    chunk: int = _DEFAULT_CHUNK,
    shard: int | str | None = None,
    tech: str = "tsv",
    bandwidth: BandwidthSpec | dict | None = None,
    device: str | torch.device | None = None,
):
    """Batched Fig.-7 argmin over tier count for every (workload, budget).

    Returns ``(best_tiers, best_cycles)`` int64/float64 arrays of shape
    (W, B) — cycles at the model's 1 GHz clock. Ties break toward fewer
    tiers, matching the scalar ``analytical.optimal_tiers`` loop
    exactly. With ``bandwidth`` set, the argmin runs over the
    bandwidth-aware roofline cycles (``tech`` selects the vertical-link
    technology for the derived vlink width) — the paper's Fig.-7 tier
    optimum under a finite memory system instead of peak compute.
    ``backend``, ``device`` and ``shard`` are as in ``evaluate``.
    """
    device = _search_device(backend, device)
    n_shards = _resolve_shards(shard, backend, device)
    wl = np.atleast_2d(np.asarray(workloads, dtype=np.int64))
    budgets = _as_1d_int(mac_budgets)
    W, B, T = wl.shape[0], budgets.shape[0], int(max_tiers)
    if bandwidth is not None and not isinstance(bandwidth, BandwidthSpec):
        bandwidth = BandwidthSpec.from_dict(bandwidth)
    # Direct search over the flattened (W x B x T) grid: unlike a full
    # evaluate() this skips the 2D-baseline pass Fig. 7 never uses.
    Mf = np.repeat(wl[:, 0], B * T)
    Kf = np.repeat(wl[:, 1], B * T)
    Nf = np.repeat(wl[:, 2], B * T)
    Lf = np.tile(np.arange(1, T + 1, dtype=np.int64), W * B)
    nm = np.tile(np.repeat(budgets, T), W)
    r, c, t = _optimize_flat(
        Mf, Kf, Nf, nm, Lf, "dos", mode, backend, chunk, device=device, n_shards=n_shards,
    )
    cyc = np.where(t != INVALID_CYCLES, t, 0).astype(np.float64)
    cyc[t == INVALID_CYCLES] = np.inf
    if bandwidth is not None:
        validate_option("tech", tech, VALID_TECHS)
        tr = gemm_traffic_batched(
            "dos", Mf, Kf, Nf, r, c, Lf, np.full(Lf.shape, tech), bandwidth
        )
        cyc, _, _ = roofline_cycles(
            cyc, tr["dram_bytes"] / bandwidth.dram_bytes_per_cycle,
            tr["vlink_cycles"],
        )
    cyc = cyc.reshape(W, B, T)
    best = np.argmin(cyc, axis=2)
    best_cycles = np.take_along_axis(cyc, best[:, :, None], axis=2)[:, :, 0]
    return best + 1, best_cycles


# ---------------------------------------------------------------------------
# Network-level scheduling (zoo -> lowering -> schedule -> report)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PolicyResult:
    """Network-level reduction of one mapping policy.

    ``per_layer``: every layer runs on its own best feasible array
    design (the DSE upper bound). ``fixed``: ONE array design (rows x
    cols x tiers) serves every layer — the physically buildable case.
    ``total_cycles`` [cycles at 1 GHz] is inf when no feasible design
    exists; ``time_s`` [s], ``energy_j`` [J], ``edp_js`` [J*s],
    ``t_max_c`` [degC]. ``stall_cycles``/``bound`` summarize the
    bandwidth-aware run (count-weighted stall total and the bound
    class carrying the largest share of runtime); they stay at their
    compute-bound defaults when ``schedule`` ran without a bandwidth
    spec.
    """

    policy: str
    total_cycles: float
    time_s: float
    energy_j: float
    edp_js: float
    total_cycles_2d: float
    speedup_vs_2d: float
    t_max_c: float
    utilization: float
    feasible: bool
    #: per-layer: (n_gemms, 3) int array of (rows, cols, tiers) per
    #: layer; fixed: the single (rows, cols, tiers) chosen.
    design: np.ndarray
    stall_cycles: float = 0.0
    bound: str = "compute"

    _FLOAT_FIELDS = (
        "total_cycles", "time_s", "energy_j", "edp_js", "total_cycles_2d",
        "speedup_vs_2d", "t_max_c", "utilization", "stall_cycles",
    )

    @classmethod
    def from_dict(cls, d: dict) -> "PolicyResult":
        kw = dict(d)
        kw["design"] = np.asarray(d["design"], dtype=np.int64)
        for name in cls._FLOAT_FIELDS:
            # float() also decodes the strict-JSON "Infinity"/"NaN"
            # encoding of non-finite values (see study._jsonify);
            # pre-bandwidth artifacts lack stall_cycles/bound and take
            # the compute-bound defaults.
            if name in kw:
                kw[name] = float(kw[name])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class NetworkReport:
    """End-to-end evaluation of one lowered network stream."""

    arch: str
    shape: str
    mode: str
    n_gemms: int
    n_gemm_invocations: int
    total_macs: int
    per_layer: PolicyResult
    fixed: PolicyResult
    #: candidate fixed designs considered / excluded purely by thermal
    n_candidates: int
    n_thermally_masked: int
    thermal_limit: float
    #: DVFS-governed transient replay of the fixed design (None on
    #: steady-state runs / pre-transient artifacts): states, residency,
    #: peak vs sustained pass time, governed excursion, feasibility.
    dvfs: dict | None = None
    #: fine-grain tier-folded policy (None unless schedule ran with
    #: 'tier_fold' in ``policies``): one fixed array, but each layer
    #: picks its best per-tier partition (m/k/n fold) on it.
    tier_fold: PolicyResult | None = None
    #: tier_fold bookkeeping: {'by_layer': [fold name per layer],
    #: 'residency': {fold: count-weighted cycle share}}.
    fold: dict | None = None

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        for pol in ("per_layer", "fixed", "tier_fold"):
            if out.get(pol) is not None:
                out[pol]["design"] = np.asarray(out[pol]["design"]).tolist()
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "NetworkReport":
        """Inverse of ``to_dict`` (lossless up to JSON float text);
        pre-fold artifacts restore with ``tier_fold``/``fold`` None."""
        kw = dict(d)
        for pol in ("per_layer", "fixed", "tier_fold"):
            v = d.get(pol)
            if v is None:
                continue
            kw[pol] = v if isinstance(v, PolicyResult) else PolicyResult.from_dict(v)
        return cls(**kw)


def _adaptive_chunk(workloads, mac_budgets) -> int:
    """Bound the (chunk, r_max) search working set to ~2^23 elements.

    Network streams carry token-sized dims (M up to tens of
    thousands), so the default 2048-wide chunks would allocate
    multi-GB tau intermediates. Results are chunk-independent."""
    wl = np.atleast_2d(np.asarray(workloads, dtype=np.int64))
    d1_max = int(wl.max())  # upper bound on D1 for any dataflow
    r_max = min(d1_max, int(np.max(mac_budgets)))
    return int(np.clip((1 << 23) // max(r_max, 1), 64, _DEFAULT_CHUNK))


def thermal_feasible(
    workloads,
    mac_budgets,
    tiers,
    dataflow: str = "dos",
    tech: str = "tsv",
    thermal_limit: float = C.THERMAL_BUDGET_C,
    backend: str = "numpy",
    device: str | torch.device | None = None,
) -> np.ndarray:
    """(W, P) bool — can each (workload, design point) run within the
    junction limit? The advisor uses this to strike 3D-stacked
    candidates whose steady-state stack temperature overshoots.
    ``backend`` and ``device`` are as in ``evaluate``."""
    wl = np.atleast_2d(np.asarray(workloads, dtype=np.int64))
    grid = DesignGrid(
        workloads=wl, tiers=_as_1d_int(tiers), mac_budgets=_as_1d_int(mac_budgets),
        dataflow=dataflow, tech=tech,
    )
    res = evaluate(
        grid, backend=backend, metrics=("thermal",),
        chunk=_adaptive_chunk(wl, grid.mac_budgets),
        thermal_limit=thermal_limit, device=device,
    )
    return res.feasible


def candidate_fixed_designs(res: EvalResult, tiers, per_point: bool = False):
    """Fixed-array candidate designs from a per-layer-optimum pass.

    The shared first half of the two-pass selection ``schedule`` and
    ``core.serve`` both run: the valid per-layer (rows, cols) optima of
    ``res`` form the candidate set for the explicit re-evaluation pass
    (scoring stays with each caller).

    Pooled (default, ``schedule``): the distinct (rows, cols, tiers)
    triples over every valid (layer, point) cell — (n_cand, 3) int64.

    ``per_point=True`` (``core.serve``): per design point j, the sorted
    distinct (rows, cols) pairs of its own valid cells, with a (1, 1)
    fallback for structurally invalid points — returns
    ``(cand_rows, cand_cols, owner)`` int64 arrays, ``owner[i]`` the
    original point index candidate i belongs to.
    """
    v = res.valid
    if not per_point:
        return np.unique(
            np.stack(
                [res.rows[v], res.cols[v], np.broadcast_to(tiers, v.shape)[v]],
                axis=1,
            ),
            axis=0,
        )
    cand_rows, cand_cols, owner = [], [], []
    for j in range(v.shape[1]):
        vj = v[:, j]
        pairs = sorted(set(zip(res.rows[vj, j].tolist(), res.cols[vj, j].tolist())))
        if not pairs:
            pairs = [(1, 1)]  # structurally invalid point (budget < tiers)
        for r, c in pairs:
            cand_rows.append(r)
            cand_cols.append(c)
            owner.append(j)
    return (
        np.asarray(cand_rows, dtype=np.int64),
        np.asarray(cand_cols, dtype=np.int64),
        np.asarray(owner, dtype=np.int64),
    )


def _reduce_policy(
    policy, counts, cycles, energy, t_max, util_den, cycles_2d, design, freq_hz,
    stall_cycles: float = 0.0, bound: str = "compute",
):
    """Totals for one policy given the per-layer chosen columns."""
    total_cycles = float(np.sum(counts * cycles))
    time_s = total_cycles / freq_hz
    energy_j = float(np.sum(counts * energy))
    total_2d = float(np.sum(counts * cycles_2d))
    with np.errstate(invalid="ignore", divide="ignore"):
        speedup = total_2d / total_cycles if total_cycles > 0 else np.nan
    feasible = bool(np.isfinite(total_cycles))
    t_max = np.asarray(t_max, dtype=np.float64)
    hot = float(np.nanmax(t_max)) if np.any(np.isfinite(t_max)) else float("nan")
    return PolicyResult(
        policy=policy,
        total_cycles=total_cycles,
        time_s=time_s,
        energy_j=energy_j,
        edp_js=energy_j * time_s,
        total_cycles_2d=total_2d,
        speedup_vs_2d=float(speedup),
        t_max_c=hot,
        utilization=float(util_den) if feasible else float("nan"),
        feasible=feasible,
        design=design,
        stall_cycles=stall_cycles,
        bound=bound,
    )


def _governed_layer_replay(
    res2: EvalResult, c_star: int, counts, dvfs: DvfsSpec, thermal_limit: float
) -> dict:
    """Replay the fixed design's layer stream under the DVFS governor.

    One pass = the whole network (every layer, count-weighted) on the
    chosen fixed array; ``dvfs.sim_steps`` passes integrate the lumped
    RC stack with a governor decision after every layer. Returns the
    report's ``dvfs`` dict — sustained (last, thermally settled) vs
    peak (cold, top-state) pass time and the governed verdict.
    """
    W = res2.cycles.shape[0]
    fx = res2.cycles[:, c_star]
    out = {
        "freqs_ghz": list(dvfs.freqs_ghz),
        "vdds_v": list(dvfs.vdds_v),
        "sim_passes": dvfs.sim_steps,
    }
    if not np.all(np.isfinite(fx)):
        out.update(feasible_transient=False, within_thermal_budget=False)
        return out
    stall = (
        np.nan_to_num(res2.stall_cycles[:, c_star])
        if res2.stall_cycles is not None
        else np.zeros(W)
    )
    compute = fx - stall
    mem = (
        res2.mem_cycles[:, c_star]
        if res2.mem_cycles is not None
        else np.zeros(W)
    )
    vl = (
        res2.vlink_cycles[:, c_star]
        if res2.vlink_cycles is not None
        else np.zeros(W)
    )
    static = res2.static_power_w[:, c_star]
    dyn = res2.dynamic_power_w[:, c_star]
    grid2 = res2.grid
    L = int(grid2.tiers[c_star])
    tech = (
        grid2.tech if isinstance(grid2.tech, str) else str(grid2.tech[c_star])
    )
    fp_mm2 = float(res2.footprint_um2[0, c_star]) * 1e-6
    macs = float(grid2.rows[c_star] * grid2.cols[c_star])
    freqs = dvfs.freqs_hz()
    sd, ss = dvfs.scales()
    tstate = ThermalState.init(
        np.array([fp_mm2]), np.array([L]), np.array([tech]), np.array([macs])
    )
    state = dvfs.n_states - 1
    resid = np.zeros(dvfs.n_states)
    t_hot = -np.inf
    pass_s = 0.0
    counts = np.asarray(counts, dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        for _ in range(dvfs.sim_steps):
            pass_s = 0.0
            for i in range(W):
                f = float(freqs[state])
                tot = max(compute[i], mem[i] * (f / C.FREQ_HZ), vl[i])
                dt = counts[i] * tot / f
                pwr = static[i] * ss[state] + dyn[i] * sd[state]
                tstate = step_temps(
                    tstate, np.full((1, L), pwr / L), np.array([dt])
                )
                tmax = float(tstate.t_max_c[0])
                t_hot = max(t_hot, tmax)
                resid[state] += 1.0
                pass_s += dt
                state = int(
                    governor_step(
                        np.array([state]), np.array([tmax]), thermal_limit, dvfs
                    )[0]
                )
        f_top = float(freqs[-1])
        peak_s = float(np.sum(
            counts
            * np.maximum(compute, np.maximum(mem * (f_top / C.FREQ_HZ), vl))
            / f_top
        ))
    out.update(
        residency=(resid / resid.sum()).tolist(),
        peak_pass_s=peak_s,
        sustained_pass_s=pass_s,
        peak_vs_sustained=pass_s / peak_s if peak_s > 0 else float("nan"),
        t_max_transient_c=t_hot,
        within_thermal_budget=bool(t_hot < thermal_limit),
        feasible_transient=bool(np.isfinite(pass_s) and t_hot < thermal_limit),
    )
    return out


def schedule(
    stream,
    mac_budgets=(2**14, 2**16, 2**18),
    tiers=tuple(range(1, 17)),
    dataflow: str = "dos",
    tech: str = "tsv",
    backend: str = "numpy",
    thermal_limit: float = C.THERMAL_BUDGET_C,
    require_feasible: bool = True,
    chunk: int | None = None,
    shard: int | str | None = None,
    bandwidth: BandwidthSpec | dict | None = None,
    thermal: str = "steady",
    dvfs: DvfsSpec | dict | None = None,
    policies: Sequence[str] = ("per_layer", "fixed"),
    device: str | torch.device | None = None,
) -> NetworkReport:
    """Evaluate a whole lowered network stream on the design grid.

    ``stream`` is a ``core.network.WorkloadStream`` (anything with
    ``.workloads`` (n, 3), ``.counts`` (n,) and the naming attributes
    works). The engine evaluates the stream batched over the (budget x
    tier) grid once, derives the candidate fixed-array designs from the
    per-layer optima, re-evaluates those shared designs explicitly, and
    reduces to network-level totals (cycles at 1 GHz, seconds, joules,
    J*s, degC) under two policies:

    - ``per_layer``: each GEMM on its own best feasible design — the
      DSE upper bound (what per-layer papers report).
    - ``fixed``: one (rows x cols x tiers) array serves every layer —
      the buildable accelerator. Its candidate set contains every
      layer's optimum, so ``fixed.total_cycles >=
      per_layer.total_cycles`` by construction.
    - ``tier_fold`` (opt-in via ``policies``): one fixed array, but
      each layer additionally picks its best per-tier partition of the
      GEMM — fold-m / fold-k / fold-n (``analytical.fold_dims``) —
      with the cross-tier reduction / operand-multicast traffic priced
      on the vertical links (``bandwidth.fold_traffic_batched``, via
      ``pricing.price_steps``). The native fold is always a candidate
      and prices identically to the fixed policy's cycles, so
      ``tier_fold.total_cycles <= fixed.total_cycles`` by construction
      (equality at one tier, where every fold degenerates to native).
      Per-fold SRAM working sets join the feasibility mask; the
      thermal verdict is inherited from the design's native-mapping
      evaluation (folds redistribute the same work across the same
      stack).

    ``policies`` must contain 'per_layer' and 'fixed' (the report's
    backbone); add 'tier_fold' for the folded policy + the report's
    ``fold`` residency dict.

    Thermal feasibility is first-class: designs whose lumped stack
    temperature reaches ``thermal_limit`` [degC] are excluded from both
    optima (``require_feasible=False`` disables the mask, for
    ablations). Speedups are against the budget-matched optimized 2D
    baseline of the same dataflow family, reduced with the same
    per-layer counts.

    ``bandwidth`` (a ``core.bandwidth.BandwidthSpec``) makes the whole
    reduction bandwidth-aware: candidate designs are still the
    compute-optimal per-layer shapes (the search is not re-run under
    stalls), but their per-layer cycles/energy include DRAM and
    vertical-link stalls, SRAM capacity joins the feasibility mask,
    and both policy optima are taken over the stalled totals — which
    can (and does; regression-pinned) flip the winning fixed design
    under a DRAM cap. Uncapped/None is bit-identical to the plain
    schedule.

    ``thermal='transient'`` reports *sustained* instead of gated-peak
    performance: the steady-state thermal mask is dropped from the
    candidate selection (structural validity and SRAM capacity still
    apply), and the winning fixed design's layer stream is replayed
    ``dvfs.sim_steps`` times under the DVFS governor against the
    transient RC stack — the report's ``dvfs`` dict carries the
    governed residency, peak-vs-sustained pass time and the governed
    excursion's own feasibility verdict.

    ``backend``, ``device`` and ``shard`` are as in ``evaluate``.
    """
    validate_option("dataflow", dataflow, VALID_DATAFLOWS)
    validate_option("tech", tech, VALID_TECHS)
    validate_option("backend", backend, VALID_BACKENDS)
    validate_option("thermal", thermal, VALID_THERMAL_MODES)
    policies = tuple(
        validate_option("policy", p, VALID_SCHEDULE_POLICIES) for p in policies
    )
    for need in ("per_layer", "fixed"):
        if need not in policies:
            raise ValueError(
                f"policies must include {need!r} (got {policies!r}); "
                "'tier_fold' is the opt-in extra"
            )
    if thermal == "transient":
        if dvfs is None:
            dvfs = DvfsSpec()
        elif not isinstance(dvfs, DvfsSpec):
            dvfs = DvfsSpec.from_dict(dvfs)
    elif dvfs is not None:
        raise ValueError("dvfs requires thermal='transient'")
    wl = np.atleast_2d(np.asarray(stream.workloads, dtype=np.int64))
    counts = np.asarray(stream.counts, dtype=np.float64)
    W = wl.shape[0]
    if counts.shape != (W,):
        raise ValueError(f"counts shape {counts.shape} != ({W},)")
    if chunk is None:
        chunk = _adaptive_chunk(wl, mac_budgets)

    # Pass 1: per-layer optimal shapes over the (budget x tier) grid —
    # only the searched (rows, cols) feed the candidate set, so skip
    # the PPA metric groups here; feasibility is applied in pass 2.
    grid = DesignGrid.product(wl, mac_budgets, tiers, dataflow=dataflow, tech=tech)
    res1 = evaluate(grid, backend=backend, metrics=("perf",), chunk=chunk, shard=shard,
                    device=device)

    # Candidate fixed designs: every distinct per-layer optimum. The
    # per-layer policy minimizes over the same candidate columns, which
    # is what makes fixed >= per_layer a theorem rather than a trend.
    cand = candidate_fixed_designs(res1, grid.tiers)
    if cand.shape[0] == 0:
        raise ValueError(f"{stream.arch}/{stream.shape}: no valid design point")

    # Pass 2: every layer on every shared candidate design (no search —
    # explicit shapes), with power/thermal for the feasibility mask.
    grid2 = DesignGrid.explicit(
        wl, rows=cand[:, 0], cols=cand[:, 1], tiers=cand[:, 2],
        dataflow=dataflow, tech=tech,
    )
    res2 = evaluate(
        grid2, backend=backend, chunk=chunk, thermal_limit=thermal_limit,
        shard=shard, bandwidth=bandwidth, device=device,
    )
    if thermal == "transient" and require_feasible:
        # sustained mode: thermal gating moves to the governed replay —
        # structural validity and SRAM capacity still mask candidates
        feas = res2.valid
        if res2.within_sram_capacity is not None:
            feas = feas & res2.within_sram_capacity
    else:
        feas = res2.feasible if require_feasible else res2.valid
    # counted from the thermal mask alone — under a bandwidth spec,
    # feasible also carries the SRAM-capacity mask, which must not be
    # misattributed to overheating in the report
    thermal_ok = res2.valid & res2.within_thermal_budget
    n_thermal_masked = int(np.sum(np.all(res2.valid, axis=0) & ~np.all(thermal_ok, axis=0)))

    cyc = np.where(feas, res2.cycles, np.inf)
    energy = np.where(feas, res2.energy_j, np.inf)
    freq = C.FREQ_HZ
    workload_macs = (wl[:, 0] * wl[:, 1] * wl[:, 2]).astype(np.float64)
    n_macs_used = (cand[:, 0] * cand[:, 1] * cand[:, 2]).astype(np.float64)

    def util(chosen_cycles, chosen_cols):
        # Useful MAC-ops per provisioned MAC-cycle over the whole run.
        den = np.sum(counts * n_macs_used[chosen_cols] * chosen_cycles)
        return np.sum(counts * workload_macs) / den if den > 0 else np.nan

    def bw_summary(chosen_cycles, layer_rows, layer_cols):
        """Count-weighted stall total [cycles] + dominant bound class."""
        if res2.stall_cycles is None:
            return 0.0, "compute"
        fin = np.isfinite(chosen_cycles)
        stall = float(np.sum(
            counts * np.where(fin, res2.stall_cycles[layer_rows, layer_cols], 0.0)
        ))
        weight = counts * np.where(fin, chosen_cycles, 0.0)
        b = res2.bound[layer_rows, layer_cols]
        shares = {n: float(np.sum(weight[b == n])) for n in BOUND_NAMES}
        return stall, max(BOUND_NAMES, key=lambda n: shares[n])

    # --- per-layer-optimal policy -------------------------------------
    best = np.argmin(cyc, axis=1)  # (W,)
    rows_w = np.arange(W)
    pl_cyc = cyc[rows_w, best]
    pl_stall, pl_bound = bw_summary(pl_cyc, rows_w, best)
    per_layer = _reduce_policy(
        "per_layer", counts, pl_cyc,
        energy[rows_w, best],
        np.where(np.isfinite(pl_cyc), res2.t_max_c[rows_w, best], np.nan),
        util(pl_cyc, best),
        np.where(np.isfinite(pl_cyc), res2.cycles_2d[rows_w, best], np.inf),
        cand[best], freq, pl_stall, pl_bound,
    )

    # --- fixed-design policy ------------------------------------------
    # inf propagation: any infeasible layer poisons the whole column.
    tot = np.sum(counts[:, None] * cyc, axis=0)
    c_star = int(np.argmin(tot))
    fx_cyc = cyc[:, c_star]
    fx_cols = np.full(W, c_star)
    fx_stall, fx_bound = bw_summary(fx_cyc, rows_w, fx_cols)
    fixed = _reduce_policy(
        "fixed", counts, fx_cyc,
        energy[:, c_star],
        np.where(np.isfinite(fx_cyc), res2.t_max_c[:, c_star], np.nan),
        util(fx_cyc, fx_cols),
        np.where(np.isfinite(fx_cyc), res2.cycles_2d[:, c_star], np.inf),
        cand[c_star], freq, fx_stall, fx_bound,
    )

    # --- tier-folded policy (opt-in) ----------------------------------
    # One fixed array like `fixed`, but each layer picks its best tier
    # fold on it. All three folds are priced through price_steps (the
    # native fold reproduces the engine's cycles bit-for-bit), so the
    # argmin can only improve on `fixed`; ties break toward native.
    tier_fold_pol = None
    fold_info = None
    if "tier_fold" in policies:
        spec_bw = bandwidth if bandwidth is not None else BandwidthSpec()
        nat = native_fold(dataflow)
        fold_order = [nat] + [f for f in FOLD_NAMES if f != nat]
        Mw, Kw, Nw = (wl[:, i][:, None] for i in range(3))
        r_c, c_c, l_c = (cand[:, i][None, :] for i in range(3))
        priced = [
            price_steps(dataflow, Mw, Kw, Nw, r_c, c_c, l_c, tech, spec_bw,
                        fold=f)
            for f in fold_order
        ]
        cyc_f = np.stack([p["total_cycles"] for p in priced])  # (3, W, n_cand)
        if require_feasible:
            ok_f = np.stack(
                [p["sram_need_bytes"] <= spec_bw.sram_bytes for p in priced]
            )
            cyc_fm = np.where(feas[None] & ok_f, cyc_f, np.inf)
        else:
            cyc_fm = np.where(feas[None], cyc_f, np.inf)
        fi = np.argmin(cyc_fm, axis=0)  # first minimum -> native on ties
        cell = np.take_along_axis(cyc_fm, fi[None], axis=0)[0]
        en_f = np.stack([p["energy_j"] for p in priced])
        cell_en = np.where(
            np.isfinite(cell),
            np.take_along_axis(en_f, fi[None], axis=0)[0],
            np.inf,
        )
        tot_f = np.sum(counts[:, None] * cell, axis=0)
        c_fold = int(np.argmin(tot_f))
        tf_cyc = cell[:, c_fold]
        fin = np.isfinite(tf_cyc)
        st_f = np.stack([p["stall_cycles"] for p in priced])
        bi_f = np.stack([p["bound_idx"] for p in priced])
        cell_st = np.take_along_axis(st_f, fi[None], axis=0)[0][:, c_fold]
        cell_bi = np.take_along_axis(bi_f, fi[None], axis=0)[0][:, c_fold]
        tf_stall = float(np.sum(counts * np.where(fin, cell_st, 0.0)))
        weight = counts * np.where(fin, tf_cyc, 0.0)
        b_names = bound_names(cell_bi)
        shares = {n: float(np.sum(weight[b_names == n])) for n in BOUND_NAMES}
        tf_bound = max(BOUND_NAMES, key=lambda n: shares[n])
        tier_fold_pol = _reduce_policy(
            "tier_fold", counts, tf_cyc, cell_en[:, c_fold],
            np.where(fin, res2.t_max_c[:, c_fold], np.nan),
            util(tf_cyc, np.full(W, c_fold)),
            np.where(fin, res2.cycles_2d[:, c_fold], np.inf),
            cand[c_fold], freq, tf_stall, tf_bound,
        )
        li = fi[:, c_fold]
        wsum = float(weight.sum())
        fold_info = {
            "by_layer": [fold_order[int(i)] for i in li],
            "residency": {
                f: (float(np.sum(weight[li == i])) / wsum if wsum > 0 else 0.0)
                for i, f in enumerate(fold_order)
            },
        }

    dvfs_report = None
    if thermal == "transient":
        dvfs_report = _governed_layer_replay(
            res2, c_star, counts, dvfs, thermal_limit
        )

    return NetworkReport(
        arch=stream.arch,
        shape=stream.shape,
        mode=str(stream.mode),
        n_gemms=W,
        n_gemm_invocations=int(counts.sum()),
        total_macs=int(np.sum(counts * workload_macs)),
        per_layer=per_layer,
        fixed=fixed,
        n_candidates=int(cand.shape[0]),
        n_thermally_masked=n_thermal_masked,
        thermal_limit=thermal_limit,
        dvfs=dvfs_report,
        tier_fold=tier_fold_pol,
        fold=fold_info,
    )


# ---------------------------------------------------------------------------
# Pareto utility (paper Sec. IV-C/D: latency-area-power trade-offs)
# ---------------------------------------------------------------------------

def pareto_frontier(points, chunk: int = 2048) -> np.ndarray:
    """Boolean mask of Pareto-optimal rows (all objectives minimized).

    ``points`` is (n, d); a row is on the frontier iff no other row is
    <= in every objective and < in at least one. Rows with non-finite
    entries are never on the frontier. The 2-objective case runs the
    sort-based O(n log n) sweep; otherwise O(n^2) in ``chunk``-sized
    blocks. Both paths are the single-workload case of
    ``pareto_mask_batched`` (regression-pinned bit-identical to the
    pre-vectorized scan by ``tests/test_engine.py``).
    """
    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    return pareto_mask_batched(pts[None, :, :], chunk=chunk)[0]


def _pareto_mask_2obj(pts: np.ndarray) -> np.ndarray:
    """(W, n, 2) -> (W, n) frontier masks via per-row lexicographic
    sort + prefix-min sweep — O(W n log n), no pairwise matrix.

    A point is dominated iff (a) some point with strictly smaller x has
    y <= its y (prefix min over earlier x-groups), or (b) a point with
    the same x has strictly smaller y (within a group, sorted by y, the
    group head holds the minimum). Ties on both coordinates keep every
    copy, matching the pairwise scan's strict-< requirement.
    """
    W, n = pts.shape[:2]
    finite = np.isfinite(pts).all(axis=-1)
    q = np.where(finite[..., None], pts, np.inf)
    x, y = q[..., 0], q[..., 1]
    # Stable two-pass argsort == per-row lexsort by (x asc, then y asc).
    o1 = np.argsort(y, axis=1, kind="stable")
    o2 = np.argsort(np.take_along_axis(x, o1, axis=1), axis=1, kind="stable")
    order = np.take_along_axis(o1, o2, axis=1)
    X = np.take_along_axis(x, order, axis=1)
    Y = np.take_along_axis(y, order, axis=1)
    F = np.take_along_axis(finite, order, axis=1)
    idx = np.arange(n)[None, :]
    new_group = np.ones((W, n), dtype=bool)
    new_group[:, 1:] = X[:, 1:] != X[:, :-1]
    group_start = np.maximum.accumulate(np.where(new_group, idx, 0), axis=1)
    # Exclusive prefix-min of Y, then snapped back to each group's
    # start: the best y among points with strictly smaller x.
    prev_min = np.full((W, n), np.inf)
    if n > 1:
        prev_min[:, 1:] = np.minimum.accumulate(Y, axis=1)[:, :-1]
    best_before = np.take_along_axis(prev_min, group_start, axis=1)
    y_head = np.take_along_axis(Y, group_start, axis=1)
    dominated = (best_before <= Y) | ((idx > group_start) & (Y > y_head)) | ~F
    mask = np.zeros((W, n), dtype=bool)
    np.put_along_axis(mask, order, ~dominated, axis=1)
    return mask


def pareto_mask_batched(points, chunk: int | None = None) -> np.ndarray:
    """(W, n, d) -> (W, n) bool: per-workload Pareto frontiers in one
    vectorized pass (all objectives minimized).

    Rows with any non-finite entry are never on a frontier and never
    dominate (they are lifted to +inf, and +inf <= finite is False).
    d == 2 takes the O(n log n) sort sweep; the general case is the
    chunked O(n^2) dominance scan with the workload axis batched in,
    ``chunk`` bounding the (W, chunk, n) block size.
    """
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim != 3:
        raise ValueError(f"points must be (W, n, d), got shape {pts.shape}")
    W, n, d = pts.shape
    if n == 0:
        return np.zeros((W, 0), dtype=bool)
    if d == 2:
        return _pareto_mask_2obj(pts)
    finite = np.isfinite(pts).all(axis=-1)
    q = np.where(finite[..., None], pts, np.inf)
    if chunk is None:
        chunk = 2048
    b = max(1, min(chunk, _AUTO_STREAM_CELLS // max(W * n, 1) + 1))
    dominated = np.zeros((W, n), dtype=bool)
    for lo in range(0, n, b):
        hi = min(lo + b, n)
        blk = q[:, lo:hi, None, :]  # (W, b, 1, d)
        allq = q[:, None, :, :]  # (W, 1, n, d)
        dom = (allq <= blk).all(-1) & (allq < blk).any(-1)  # (W, b, n)
        dominated[:, lo:hi] = dom.any(-1)
    return finite & ~dominated


# ---------------------------------------------------------------------------
# Batched TPU-mesh strategy scoring (what core.advisor ranks with)
# ---------------------------------------------------------------------------

_BF16 = 2  # bytes
#: per-hop ICI latency. This is where the paper's (l-1) *serial* adder
#: term survives on a mesh: a ring collective over an axis of size l
#: costs ~2(l-1) latency hops regardless of payload, so the dOS total is
#: convex in l exactly like Eq. 2.
ICI_HOP_LATENCY_S = 1e-6

MESH_STRATEGIES = ("replicate", "shard_M", "shard_N", "shard_K")


def score_mesh_strategies(
    M,
    K,
    N,
    axis,
    bytes_per_el: int = _BF16,
    flops_per_s: float = C.TPU_PEAK_FLOPS_BF16,
    hbm_bw: float = C.TPU_HBM_BW,
    ici_bw: float = C.TPU_ICI_BW_PER_LINK,
    mxu_tile: int = 128,
):
    """Batched advisor scoring: cost every GEMM x every mesh strategy.

    Vectorized over broadcastable ``M, K, N, axis``. Returns a dict
    ``{strategy: {'compute_s', 'memory_s', 'collective_s', 'total_s'}}``
    of float64 arrays. The compute term includes the paper's
    fill/quantization effect: a per-device output tile smaller than the
    MXU tile wastes the systolic array exactly like the paper's
    ceil(M/R)ceil(N/C) rounding — this is how N_macs > M*N re-emerges
    at chip level. ``core.advisor.score_strategies`` is the
    batch-of-one wrapper.
    """
    Mi, Ki, Ni, L = np.broadcast_arrays(
        *(np.asarray(x, dtype=np.int64) for x in (M, K, N, axis))
    )
    # Dimension products (M*N*K and friends) overflow int64 for very
    # large GEMMs; float64 keeps them finite like the old Python-int
    # scalar scoring did, and is exact below 2^53.
    M, K, N = (a.astype(np.float64) for a in (Mi, Ki, Ni))
    b = bytes_per_el

    def eff(m, n, k):
        um = -(-m // mxu_tile) * mxu_tile
        un = -(-n // mxu_tile) * mxu_tile
        uk = -(-k // 8) * 8
        return (m * n * k) / (um * un * uk)

    def compute_t(m, n, k):
        e = np.maximum(eff(m, n, k), 1e-6)
        return 2.0 * m * n * k / (flops_per_s * e) / 1.0

    def memory_t(m, n, k):
        return b * (m * k + k * n + m * n) / hbm_bw

    def ring_allreduce(nbytes):
        return 2.0 * (L - 1) / L * nbytes / ici_bw + 2 * (L - 1) * ICI_HOP_LATENCY_S

    def ring_allgather(nbytes_shard):
        return (L - 1) * nbytes_shard / ici_bw + (L - 1) * ICI_HOP_LATENCY_S

    zeros = np.zeros(np.broadcast_shapes(M.shape), dtype=np.float64)
    mL = (-(-Mi // L)).astype(np.float64)
    nL = (-(-Ni // L)).astype(np.float64)
    kL = (-(-Ki // L)).astype(np.float64)
    out = {
        "replicate": (compute_t(M, N, K), memory_t(M, N, K), zeros),
        "shard_M": (compute_t(mL, N, K), memory_t(mL, N, K), zeros),
        "shard_N": (
            compute_t(M, nL, K),
            memory_t(M, nL, K),
            ring_allgather(b * M * nL),
        ),
        "shard_K": (
            compute_t(M, N, kL),
            memory_t(M, N, kL),
            ring_allreduce(b * M * N),
        ),
    }
    return {
        name: {
            "compute_s": comp,
            "memory_s": mem,
            "collective_s": coll,
            # Compute and memory overlap on TPU; the collective is
            # serialized (paper-faithful: sequential adder pile).
            "total_s": np.maximum(comp, mem) + coll,
        }
        for name, (comp, mem, coll) in out.items()
    }
