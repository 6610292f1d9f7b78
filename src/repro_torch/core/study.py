"""One front door over the DSE stack: declarative, serializable studies.

A numpy copy of the JAX package's ``core/study.py``: a spec hashes to
the same cache directory name in both packages and its payload carries
the same bits. What the port adds is where the work runs:
``AnalysisSpec.backend`` is ``'torch'`` (the default) or ``'numpy'``,
and ``AnalysisSpec.device`` names the torch backend's device (``None``:
the card). The ``calibrate`` kind measures the port's kernels on
``device`` whatever the backend.

The paper's results (Figs. 5-8, Table I) are joint sweeps over
workload x (MAC budget, tiers, dataflow, tech) under a thermal
constraint. This module makes such a sweep a *first-class artifact*: a
``Study`` is four small JSON-round-trippable specs —

- ``WorkloadSpec``: what runs — a raw GEMM list, a model-zoo network
  lowered via ``core.network.lower_network``, or the Fig.-7 random
  workload generator (``core.dse.random_workloads``);
- ``SpaceSpec``: the design space — MAC budgets x tiers (product or
  parallel explicit points), optional fixed rows/cols, dataflow, tech;
- ``ConstraintSpec``: thermal junction limit, optional area / power /
  MAC-budget caps, and whether optima must be feasible;
- ``AnalysisSpec``: which question to ask — ``evaluate`` | ``schedule``
  | ``pareto`` | ``advise`` | ``sweep`` (the paper figures);

— compiled by ``Study.run()`` into **one** pass through the existing
batched engine (``core.engine``) and returned as a versioned
``StudyResult`` that echoes the inputs and serializes to JSON
(``save``/``load``/``to_json``/``from_json``). The legacy entry points
(``dse.fig5_sweep``/``fig6_sweep``/``fig7_scatter``,
``advisor.rank_candidates``) are thin wrappers over these specs, and
``python -m repro_torch`` exposes the same studies from the shell:

    PYTHONPATH=src python -m repro_torch example-spec evaluate > spec.json
    PYTHONPATH=src python -m repro_torch run spec.json --out artifact.json

In-memory, ``StudyResult.payload`` keeps the engine's typed objects
(``EvalResult`` / ``NetworkReport`` / numpy arrays) so the facade adds
no conversion cost over a direct engine call; JSON conversion happens
only in ``to_dict``/``to_json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import re

import numpy as np
import torch

from .._device import resolve_device
from . import calibrate as _calibrate
from .bandwidth import BOUND_NAMES, BandwidthSpec
from .cache import ResultCache
from .calibrate import CalibrateSpec, CalibratedBandwidth
from .engine import (
    MESH_STRATEGIES,
    DesignGrid,
    EvalResult,
    NetworkReport,
    _adaptive_chunk,
    evaluate,
    optimal_tiers_batched,
    schedule,
)
from .params import (
    VALID_BACKENDS,
    VALID_DATAFLOWS,
    VALID_METRICS,
    VALID_MODES,
    VALID_OBJECTIVES,
    VALID_SCHEDULE_POLICIES,
    VALID_TECHS,
    VALID_THERMAL_MODES,
    validate_option,
    validate_options,
)
from .ppa import constants as C
from .pricing import DvfsSpec
from .search import SearchSpec, run_search
from .serve import ServeSpec, TrafficSpec, restore_points, run_serve

__all__ = [
    "ANALYSIS_KINDS",
    "SPEC_VERSION",
    "SWEEP_FIGURES",
    "WORKLOAD_KINDS",
    "AnalysisSpec",
    "BandwidthSpec",
    "CalibrateSpec",
    "CalibratedBandwidth",
    "ConstraintSpec",
    "DvfsSpec",
    "SearchSpec",
    "ServeSpec",
    "SpaceSpec",
    "Study",
    "StudyResult",
    "TrafficSpec",
    "WorkloadSpec",
    "calibrate_chunk_key",
]

#: bumped whenever the spec/artifact schema changes incompatibly.
SPEC_VERSION = 1

WORKLOAD_KINDS = ("gemms", "network", "random")
ANALYSIS_KINDS = (
    "evaluate", "schedule", "pareto", "advise", "sweep", "roofline", "search",
    "calibrate", "serve",
)
SWEEP_FIGURES = ("fig5", "fig6", "fig7")


# ---------------------------------------------------------------------------
# Normalization / JSON helpers
# ---------------------------------------------------------------------------

def _int_tuple(name: str, v) -> tuple[int, ...] | None:
    if v is None:
        return None
    try:
        return tuple(int(x) for x in np.atleast_1d(np.asarray(v)).tolist())
    except (TypeError, ValueError):
        raise ValueError(f"{name} must be an int sequence, got {v!r}") from None


def _str_or_tuple(v):
    return v if isinstance(v, str) else tuple(str(x) for x in v)


def _jsonify(v):
    """Engine objects / numpy -> JSON-compatible plain Python.

    Non-finite floats become the strings ``"Infinity"`` / ``"-Infinity"``
    / ``"NaN"`` so artifacts are *strict* JSON (parseable by jq /
    JavaScript, not just Python); ``float(...)`` and
    ``np.asarray(..., dtype=float)`` on the decode paths restore them
    exactly. ``to_json`` serializes with ``allow_nan=False`` so a raw
    token can never slip through.
    """
    if isinstance(v, (EvalResult, NetworkReport, DesignGrid)):
        return _jsonify(v.to_dict())
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return _jsonify(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {str(k): _jsonify(x) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        if np.issubdtype(v.dtype, np.floating) and not np.isfinite(v).all():
            return _jsonify(v.tolist())
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_jsonify(x) for x in v]
    if isinstance(v, np.generic):
        return _jsonify(v.item())
    if isinstance(v, float) and not math.isfinite(v):
        return "NaN" if math.isnan(v) else ("Infinity" if v > 0 else "-Infinity")
    return v


# ---------------------------------------------------------------------------
# Spec layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _ResolvedWorkload:
    """The stream-shaped object every analysis consumes (duck-typed to
    ``core.network.WorkloadStream`` for ``engine.schedule``)."""

    workloads: np.ndarray
    counts: np.ndarray
    arch: str
    shape: str
    mode: str = "gemm"


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """What runs. ``kind``:

    - ``'gemms'``: explicit ``gemms`` = ((M, K, N), ...) rows with
      optional per-row ``counts`` (multiplicities for ``schedule``);
    - ``'network'``: the model-zoo config ``arch`` lowered for shape
      ``shape`` via ``core.network.lower_network``;
    - ``'random'``: ``n`` Fig.-7-style random workloads from
      ``core.dse.random_workloads(n, seed)``.
    """

    kind: str = "gemms"
    gemms: tuple[tuple[int, int, int], ...] = ()
    counts: tuple[int, ...] | None = None
    arch: str | None = None
    shape: str | None = None
    n: int = 300
    seed: int = 0

    def __post_init__(self):
        validate_option("workload kind", self.kind, WORKLOAD_KINDS)
        gemms = ()
        if len(self.gemms):
            arr = np.atleast_2d(np.asarray(self.gemms, dtype=np.int64))
            if arr.ndim != 2 or arr.shape[1] != 3:
                raise ValueError(
                    f"gemms must be (M, K, N) rows, got shape {arr.shape}"
                )
            gemms = tuple(tuple(int(x) for x in row) for row in arr.tolist())
        object.__setattr__(self, "gemms", gemms)
        object.__setattr__(self, "counts", _int_tuple("counts", self.counts))
        object.__setattr__(self, "n", int(self.n))
        object.__setattr__(self, "seed", int(self.seed))
        if self.kind == "gemms":
            if not self.gemms:
                raise ValueError("kind='gemms' needs gemms = ((M, K, N), ...) rows")
            if self.counts is not None and len(self.counts) != len(self.gemms):
                raise ValueError(
                    f"counts length {len(self.counts)} != {len(self.gemms)} gemms"
                )
        elif self.kind == "network":
            from ..configs import REGISTRY, SHAPES  # deferred: registry import

            validate_option("arch", self.arch, tuple(sorted(REGISTRY)))
            validate_option("shape", self.shape, tuple(sorted(SHAPES)))
        elif self.n < 1:
            raise ValueError(f"kind='random' needs n >= 1, got {self.n}")

    def resolve(self):
        """-> a stream (``workloads``/``counts``/naming attributes)."""
        if self.kind == "network":
            from ..configs import REGISTRY, SHAPES
            from .network import lower_network

            return lower_network(REGISTRY[self.arch], SHAPES[self.shape])
        if self.kind == "random":
            from .dse import random_workloads

            wl = random_workloads(self.n, self.seed)
            return _ResolvedWorkload(
                workloads=wl,
                counts=np.ones(wl.shape[0], dtype=np.int64),
                arch=f"random-{self.n}",
                shape=f"seed-{self.seed}",
            )
        wl = np.asarray(self.gemms, dtype=np.int64)
        counts = (
            np.asarray(self.counts, dtype=np.int64)
            if self.counts is not None
            else np.ones(wl.shape[0], dtype=np.int64)
        )
        return _ResolvedWorkload(
            workloads=wl, counts=counts, arch="gemms", shape=f"{wl.shape[0]}x3"
        )

    def to_dict(self) -> dict:
        return _jsonify(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class SpaceSpec:
    """The design space. ``layout='product'`` crosses ``mac_budgets`` x
    ``tiers`` (budget-major, like ``DesignGrid.product``);
    ``layout='explicit'`` zips the per-point arrays in parallel. Fixed
    per-tier shapes (``rows``/``cols``) skip the (R, C) search."""

    mac_budgets: tuple[int, ...] | None = (2**14, 2**16, 2**18)
    tiers: tuple[int, ...] = tuple(range(1, 17))
    rows: tuple[int, ...] | None = None
    cols: tuple[int, ...] | None = None
    dataflow: str | tuple[str, ...] = "dos"
    tech: str | tuple[str, ...] = "tsv"
    mode: str = "opt"
    layout: str = "product"

    def __post_init__(self):
        for name in ("mac_budgets", "tiers", "rows", "cols"):
            object.__setattr__(self, name, _int_tuple(name, getattr(self, name)))
        for name in ("dataflow", "tech"):
            object.__setattr__(self, name, _str_or_tuple(getattr(self, name)))
        validate_options("dataflow", self.dataflow, VALID_DATAFLOWS)
        validate_options("tech", self.tech, VALID_TECHS)
        validate_option("mode", self.mode, VALID_MODES)
        validate_option("layout", self.layout, ("product", "explicit"))
        if (self.rows is None) != (self.cols is None):
            raise ValueError("rows and cols must be given together")
        if self.rows is None and self.mac_budgets is None:
            raise ValueError("need either mac_budgets or explicit rows+cols")

    def _df_tech(self) -> dict:
        return {
            name: (v if isinstance(v, str) else np.asarray(v))
            for name, v in (("dataflow", self.dataflow), ("tech", self.tech))
        }

    def to_grid(self, workloads) -> DesignGrid:
        kw = dict(self._df_tech(), mode=self.mode)
        if self.rows is not None:
            return DesignGrid.explicit(
                workloads, rows=self.rows, cols=self.cols, tiers=self.tiers, **kw
            )
        if self.layout == "product":
            return DesignGrid.product(
                workloads, mac_budgets=self.mac_budgets, tiers=self.tiers, **kw
            )
        return DesignGrid(
            workloads=workloads, tiers=self.tiers, mac_budgets=self.mac_budgets, **kw
        )

    def to_dict(self) -> dict:
        return _jsonify(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: dict) -> "SpaceSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """Feasibility constraints. The thermal limit [degC] feeds the
    engine's first-class mask; the optional caps additionally strike
    design points whose provisioned MAC budget [MACs] / silicon area
    [um^2] / average power [W] / minimal SRAM working set [KiB per
    tier] overshoot (reported as ``constraint_mask`` in the payload).
    ``max_sram_kib_per_tier`` is the capacity cap: it needs the
    bandwidth model active (``AnalysisSpec.bandwidth``) so
    ``sram_need_bytes`` exists to compare against.
    ``require_feasible=False`` lets optima/frontiers ignore the mask
    (ablations)."""

    thermal_limit_c: float = C.THERMAL_BUDGET_C
    max_mac_budget: int | None = None
    max_area_um2: float | None = None
    max_power_w: float | None = None
    max_sram_kib_per_tier: float | None = None
    require_feasible: bool = True

    def __post_init__(self):
        object.__setattr__(self, "thermal_limit_c", float(self.thermal_limit_c))
        if self.max_mac_budget is not None:
            object.__setattr__(self, "max_mac_budget", int(self.max_mac_budget))
        for name in ("max_area_um2", "max_power_w", "max_sram_kib_per_tier"):
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(self, name, float(v))
        object.__setattr__(self, "require_feasible", bool(self.require_feasible))

    @property
    def has_caps(self) -> bool:
        return any(
            v is not None
            for v in (self.max_mac_budget, self.max_area_um2, self.max_power_w,
                      self.max_sram_kib_per_tier)
        )

    def mask(self, res: EvalResult) -> np.ndarray:
        """(W, P) bool: engine feasibility AND every requested cap."""
        m = res.feasible
        grid = res.grid
        if self.max_mac_budget is not None:
            b = (
                grid.mac_budgets
                if grid.mac_budgets is not None
                else grid.rows * grid.cols * grid.tiers
            )
            m = m & (b <= self.max_mac_budget)[None, :]
        if self.max_sram_kib_per_tier is not None:
            if res.sram_need_bytes is None:
                raise ValueError(
                    "max_sram_kib_per_tier needs the bandwidth model active "
                    "(set AnalysisSpec.bandwidth) so sram_need_bytes exists"
                )
            m = m & (res.sram_need_bytes <= self.max_sram_kib_per_tier * 1024.0)
        for cap, metric in (
            (self.max_area_um2, "area_um2"),
            (self.max_power_w, "power_w"),
        ):
            if cap is None:
                continue
            v = getattr(res, metric)
            if v is None:
                raise ValueError(
                    f"constraint on {metric} needs that metric evaluated "
                    f"(add the matching group to AnalysisSpec.metrics)"
                )
            with np.errstate(invalid="ignore"):
                m = m & (np.nan_to_num(v, nan=np.inf) <= cap)
        return m

    def to_dict(self) -> dict:
        return _jsonify(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: dict) -> "ConstraintSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class AnalysisSpec:
    """Which question the study asks.

    - ``'evaluate'``: every (workload, design point) metric group in
      ``metrics`` (one batched ``engine.evaluate``).
    - ``'pareto'``: evaluate + the per-workload Pareto frontier over
      ``objectives`` (minimized), feasibility-restricted.
    - ``'schedule'``: the workload as ONE network stream through
      ``engine.schedule`` (per-layer-optimal vs fixed-design policies).
    - ``'advise'``: the TPU-mesh advisor — rank the four sharding
      strategies for every GEMM on a mesh axis of size ``axis``; with
      ``mac_budget`` set, ``shard_K`` (the 3D-stacked dOS mapping) is
      thermally struck when infeasible. Extra roofline knobs go in
      ``params``.
    - ``'sweep'``: a paper figure (``figure`` in fig5|fig6|fig7) over
      the study's space.
    - ``'roofline'``: evaluate under the (required) ``bandwidth``
      memory system and classify every design point as compute- /
      memory- / vlink-bound, with the stall breakdown in the payload.
    - ``'search'``: guided Pareto search (``core.search``) over the
      space's axes (plus the ``search`` spec's optional memory-system
      axes) — successive halving + evolutionary proposals, one engine
      batch per generation; needs a ``search`` ``SearchSpec``.
      ``workers`` (an execution knob, like backend/chunk/shard: never
      part of the cache key) farms each generation's missing cache
      blocks to N worker processes (``parallel.work_queue``).
    - ``'calibrate'``: measure the real kernels over ``calibrate``'s
      (a ``core.calibrate.CalibrateSpec``, defaulted when omitted)
      shape grid and fit the roofline model to the timings; the
      payload's ``artifact`` is a ``CalibratedBandwidth`` any other
      study accepts via ``bandwidth=``. The workload spec is ignored
      (the "workload" IS the calibration grid); each measured shape is
      one cache chunk, so ``--resume`` replays finished shapes.
    - ``'serve'``: the serving-traffic simulator (``core.serve``,
      defaulted ``serve`` ``ServeSpec`` when omitted) — step a seeded
      batched request queue (admit -> chunked prefill -> interleaved
      decode -> retire) on every design point of the space, pricing
      each step through the bandwidth-aware engine, and reduce to
      tokens/s, p50/p99 TTFT + per-output-token latency, energy/token
      and tokens/s/W per point. Needs a ``kind='network'`` workload;
      design-point blocks are the cache chunks (``--resume`` replays
      finished points bit-for-bit). A ``CalibratedBandwidth`` artifact
      passed as ``bandwidth=`` prices traffic on fitted constants.

    ``bandwidth`` (a ``core.bandwidth.BandwidthSpec`` or its dict
    form) attaches the bandwidth-aware runtime model to ANY kind:
    evaluate/pareto/sweep results gain ``stall_cycles``/``bound`` and
    the SRAM feasibility mask, schedule reduces over stalled cycles,
    and advise maps a finite ``dram_gbs`` [GB/s] onto the mesh
    advisor's HBM term. ``None`` (default) keeps the compute-bound
    model bit-for-bit.

    ``thermal`` selects the thermal model: ``'steady'`` (default) gates
    on the worst-case lumped steady state at the fixed 1 GHz clock —
    bit-identical to studies written before the knob existed — while
    ``'transient'`` time-steps the same RC stack under a discrete DVFS
    governor (``dvfs``, a ``core.pricing.DvfsSpec`` or its dict form,
    defaulted when omitted) and reports *sustained* performance:
    evaluate/pareto/roofline points gain ``sustained_per_s`` /
    ``peak_vs_sustained`` / ``t_max_transient_c`` / ``dvfs_residency``,
    schedule reports the governed replay of its fixed design, and
    serve's queue stepping is governed end-to-end (tokens/s *is*
    sustained). ``dvfs`` without ``thermal='transient'`` is an error.

    ``policies`` (schedule studies only) selects which scheduling
    policies ``engine.schedule`` reports. ``None`` (default) keeps the
    engine default — ``('per_layer', 'fixed')``, bit-identical to
    studies written before the knob existed; add ``'tier_fold'`` to
    also price the fine-grain tier-folded mapping (each layer's GEMM
    partitioned across tiers along its best dimension, vlink-priced).

    ``chunk=None`` uses the engine default, except for network
    workloads where the adaptive bound kicks in (token-sized M dims).
    ``shard`` is the engine's device-sharding knob (``'auto'`` and
    ``None`` stay on one device; an explicit count > 1 raises until the
    sharded search is ported).

    ``backend`` is ``'torch'`` (the default) or ``'numpy'`` (the
    engine's; identical integers, so the default changes no result). ``device`` is the torch backend's device (``'cuda'``,
    ``'cuda:N'`` or ``'cpu'``; ``None`` means the card, resolved when
    the study runs) and is rejected with ``backend='numpy'``. The
    ``calibrate`` kind is the exception: there ``device`` is where the
    kernels are measured whatever the backend, and ``None`` is the card.
    Like backend, device is an execution knob outside the cache key.
    """

    kind: str = "evaluate"
    metrics: tuple[str, ...] = ("perf", "area", "power", "thermal")
    backend: str = "torch"
    device: str | None = None
    chunk: int | None = None
    shard: int | str | None = None
    objectives: tuple[str, ...] = ("cycles", "area_um2", "power_w")
    axis: int = 16
    mac_budget: int | None = None
    figure: str | None = None
    bandwidth: BandwidthSpec | dict | None = None
    search: SearchSpec | dict | None = None
    calibrate: CalibrateSpec | dict | None = None
    serve: ServeSpec | dict | None = None
    thermal: str = "steady"
    dvfs: DvfsSpec | dict | None = None
    policies: tuple[str, ...] | None = None
    workers: int | None = None
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        validate_option("analysis kind", self.kind, ANALYSIS_KINDS)
        validate_option("backend", self.backend, VALID_BACKENDS)
        if self.device is not None:
            try:
                dev = torch.device(str(self.device))
            except RuntimeError:
                dev = None
            if dev is None or dev.type not in ("cuda", "cpu"):
                raise ValueError(
                    f"invalid device {self.device!r}; use 'cuda', 'cuda:N' or 'cpu'"
                )
            if self.backend == "numpy" and self.kind != "calibrate":
                raise ValueError(
                    f"device={self.device!r} applies to backend='torch' (and to "
                    "kind='calibrate') only; the numpy backend takes no device"
                )
            object.__setattr__(self, "device", str(dev))
        if self.search is not None and not isinstance(self.search, SearchSpec):
            if not isinstance(self.search, dict):
                raise ValueError(
                    f"search must be a SearchSpec or dict, "
                    f"got {type(self.search).__name__}"
                )
            object.__setattr__(self, "search", SearchSpec.from_dict(self.search))
        if self.kind == "search":
            if self.search is None:
                raise ValueError(
                    "kind='search' needs a search= SearchSpec (objectives, "
                    "generations, population, refinement schedule, seed)"
                )
            if self.bandwidth is None and (
                self.search.dram_gbs is not None or self.search.sram_kib is not None
            ):
                raise ValueError(
                    "the search's dram_gbs/sram_kib memory-system axes need "
                    "a bandwidth= spec (the model they parameterize)"
                )
        if self.calibrate is not None and not isinstance(self.calibrate, CalibrateSpec):
            if not isinstance(self.calibrate, dict):
                raise ValueError(
                    f"calibrate must be a CalibrateSpec or dict, "
                    f"got {type(self.calibrate).__name__}"
                )
            object.__setattr__(
                self, "calibrate", CalibrateSpec.from_dict(self.calibrate)
            )
        if self.kind == "calibrate" and self.calibrate is None:
            object.__setattr__(self, "calibrate", CalibrateSpec())
        if self.serve is not None and not isinstance(self.serve, ServeSpec):
            if not isinstance(self.serve, dict):
                raise ValueError(
                    f"serve must be a ServeSpec or dict, "
                    f"got {type(self.serve).__name__}"
                )
            object.__setattr__(self, "serve", ServeSpec.from_dict(self.serve))
        if self.kind == "serve" and self.serve is None:
            object.__setattr__(self, "serve", ServeSpec())
        validate_option("thermal", self.thermal, VALID_THERMAL_MODES)
        if self.dvfs is not None and not isinstance(self.dvfs, DvfsSpec):
            if not isinstance(self.dvfs, dict):
                raise ValueError(
                    f"dvfs must be a DvfsSpec or dict, "
                    f"got {type(self.dvfs).__name__}"
                )
            object.__setattr__(self, "dvfs", DvfsSpec.from_dict(self.dvfs))
        if self.thermal == "transient":
            if self.kind not in (
                "evaluate", "pareto", "roofline", "schedule", "serve"
            ):
                raise ValueError(
                    f"thermal='transient' applies to evaluate/pareto/"
                    f"roofline/schedule/serve studies, not kind="
                    f"{self.kind!r}"
                )
            if (
                self.kind in ("evaluate", "pareto", "roofline")
                and "thermal" not in self.metrics
            ):
                raise ValueError(
                    "thermal='transient' needs the 'thermal' metric group "
                    "in metrics= (the governor integrates the RC stack)"
                )
            if self.dvfs is None:
                object.__setattr__(self, "dvfs", DvfsSpec())
        elif self.dvfs is not None:
            raise ValueError(
                "dvfs= needs thermal='transient' (the governor only runs "
                "in the transient model)"
            )
        if self.policies is not None:
            if self.kind != "schedule":
                raise ValueError(
                    "policies= applies to schedule studies only "
                    f"(got kind={self.kind!r})"
                )
            pols = tuple(
                validate_option("policy", p, VALID_SCHEDULE_POLICIES)
                for p in self.policies
            )
            if "per_layer" not in pols or "fixed" not in pols:
                raise ValueError(
                    "policies must include 'per_layer' and 'fixed' (the "
                    "baselines every schedule report is anchored on)"
                )
            object.__setattr__(self, "policies", pols)
        if self.workers is not None:
            n = int(self.workers)
            if n < 1:
                raise ValueError(f"workers must be >= 1, got {self.workers}")
            object.__setattr__(self, "workers", n)
        if self.bandwidth is not None and not isinstance(self.bandwidth, BandwidthSpec):
            # A CalibratedBandwidth (or its dict form — recognizable by
            # the embedded spec + efficiency/marker keys) unwraps to its
            # fitted BandwidthSpec here, so a measured artifact plugs
            # into any study exactly where an assumed spec would go —
            # and reloading the spec from JSON normalizes identically.
            bw = self.bandwidth
            if isinstance(bw, dict) and ("calibrated" in bw or
                                         ("bandwidth" in bw and "efficiency" in bw)):
                bw = CalibratedBandwidth.from_dict(bw)
            if isinstance(bw, CalibratedBandwidth):
                object.__setattr__(self, "bandwidth", bw.bandwidth)
            elif not isinstance(bw, dict):
                raise ValueError(
                    f"bandwidth must be a BandwidthSpec, CalibratedBandwidth "
                    f"or dict, got {type(bw).__name__}"
                )
            else:
                object.__setattr__(self, "bandwidth", BandwidthSpec.from_dict(bw))
        if self.kind == "roofline" and self.bandwidth is None:
            raise ValueError(
                "kind='roofline' needs a bandwidth= spec — the memory system "
                "whose bounds it classifies (e.g. BandwidthSpec.paper_default())"
            )
        if self.shard is not None and self.shard not in ("auto", "none"):
            try:
                n = int(self.shard)
            except (TypeError, ValueError):
                raise ValueError(
                    f"shard must be None, 'auto', 'none' or a positive int, "
                    f"got {self.shard!r}"
                ) from None
            if n < 1:
                raise ValueError(f"shard must be >= 1, got {n}")
            object.__setattr__(self, "shard", n)
        object.__setattr__(
            self, "metrics", tuple(validate_option("metric", m, VALID_METRICS)
                                   for m in self.metrics)
        )
        object.__setattr__(
            self, "objectives",
            tuple(validate_option("objective", o, VALID_OBJECTIVES)
                  for o in self.objectives),
        )
        object.__setattr__(self, "axis", int(self.axis))
        if self.chunk is not None:
            object.__setattr__(self, "chunk", int(self.chunk))
        if self.mac_budget is not None:
            object.__setattr__(self, "mac_budget", int(self.mac_budget))
        if self.kind == "sweep":
            validate_option("sweep figure", self.figure, SWEEP_FIGURES)
        if not isinstance(self.params, dict):
            raise ValueError(f"params must be a dict, got {type(self.params).__name__}")

    def to_dict(self) -> dict:
        return _jsonify(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: dict) -> "AnalysisSpec":
        return cls(**d)


# ---------------------------------------------------------------------------
# The study itself
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Study:
    """A declarative, reproducible DSE study (the one front door).

    ``run()`` compiles the four specs into the batched engine and
    returns a ``StudyResult``. The whole object round-trips through
    JSON, so a study can be checked in, re-run, and diffed.
    """

    workload: WorkloadSpec
    space: SpaceSpec = dataclasses.field(default_factory=SpaceSpec)
    constraints: ConstraintSpec = dataclasses.field(default_factory=ConstraintSpec)
    analysis: AnalysisSpec = dataclasses.field(default_factory=AnalysisSpec)
    name: str = ""

    def __post_init__(self):
        for name, typ in (
            ("workload", WorkloadSpec),
            ("space", SpaceSpec),
            ("constraints", ConstraintSpec),
            ("analysis", AnalysisSpec),
        ):
            v = getattr(self, name)
            if isinstance(v, dict):
                object.__setattr__(self, name, typ.from_dict(v))
            elif not isinstance(v, typ):
                raise ValueError(f"{name} must be a {typ.__name__} (or dict)")

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "version": SPEC_VERSION,
            "name": self.name,
            "workload": self.workload.to_dict(),
            "space": self.space.to_dict(),
            "constraints": self.constraints.to_dict(),
            "analysis": self.analysis.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Study":
        version = int(d.get("version", SPEC_VERSION))
        if version > SPEC_VERSION:
            raise ValueError(
                f"spec version {version} is newer than supported {SPEC_VERSION}"
            )
        if "workload" not in d:
            raise ValueError("a study spec needs at least a 'workload' section")
        kw = {"workload": WorkloadSpec.from_dict(d["workload"]),
              "name": str(d.get("name", ""))}
        for name, typ in (
            ("space", SpaceSpec),
            ("constraints", ConstraintSpec),
            ("analysis", AnalysisSpec),
        ):
            if d.get(name) is not None:
                kw[name] = typ.from_dict(d[name])
        return cls(**kw)

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, allow_nan=False)

    @classmethod
    def from_json(cls, s: str) -> "Study":
        return cls.from_dict(json.loads(s))

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path) -> "Study":
        return cls.from_json(pathlib.Path(path).read_text())

    # -- execution ----------------------------------------------------------

    def run(self, cache=None) -> "StudyResult":
        """Compile the specs into the engine and return the artifact.

        The payload's units follow ``engine.EvalResult`` /
        ``engine.PolicyResult``: cycles at the model's 1 GHz clock,
        bytes, watts, joules, J*s, um^2, degC; bandwidth knobs are
        GB/s (DRAM) and KiB (SRAM per tier).

        ``cache`` (a path or ``core.cache.ResultCache``) turns on
        content-addressed chunk caching: the grid is split into
        sub-grid chunks keyed by the canonical spec hash + index range,
        already-cached chunks are loaded instead of recomputed
        (bit-for-bit — chunking never changes results), and freshly
        computed chunks are stored so an interrupted run resumes where
        it left off (``python -m repro_torch run --resume``). The returned
        ``StudyResult.cache`` carries the hit/miss counters.
        """
        if cache is not None and not isinstance(cache, ResultCache):
            cache = ResultCache(cache)
        stream = self.workload.resolve()
        runner = getattr(self, f"_run_{self.analysis.kind}")
        if cache is None:
            payload = runner(stream)
            return StudyResult(study=self, kind=self.analysis.kind, payload=payload)
        cache.prepare(self)
        h0, m0 = cache.hits, cache.misses  # shared caches: report this run only
        payload = runner(stream, cache=cache)
        stats = dict(cache.stats())
        stats["hits"] -= h0
        stats["misses"] -= m0
        stats["chunks"] = stats["hits"] + stats["misses"]
        result = StudyResult(
            study=self, kind=self.analysis.kind, payload=payload,
            cache=stats,
        )
        cache.store_result(self, result)
        return result

    def _chunk_for(self, workloads) -> int | None:
        a = self.analysis
        if a.chunk is not None:
            return a.chunk
        if self.workload.kind == "network" and self.space.mac_budgets is not None:
            # token-sized M dims: bound the search working set like
            # engine.schedule does (results are chunk-independent).
            return _adaptive_chunk(workloads, self.space.mac_budgets)
        return None

    def _evaluate(self, stream, metrics=None, cache: ResultCache | None = None) -> EvalResult:
        grid = self.space.to_grid(stream.workloads)
        kw = {}
        chunk = self._chunk_for(stream.workloads)
        if chunk is not None:
            kw["chunk"] = chunk
        kw["backend"] = self.analysis.backend
        kw["metrics"] = self.analysis.metrics if metrics is None else metrics
        kw["thermal_limit"] = self.constraints.thermal_limit_c
        kw["shard"] = self.analysis.shard
        kw["device"] = self.analysis.device
        kw["bandwidth"] = self.analysis.bandwidth
        if self.analysis.thermal == "transient" and "thermal" in kw["metrics"]:
            kw["thermal"] = "transient"
            kw["dvfs"] = self.analysis.dvfs
        if cache is None:
            return evaluate(grid, **kw)
        # Chunked, cached execution: consecutive point-blocks, each
        # independently evaluated (or loaded) and stitched — identical
        # bits to the one-pass evaluate by rowwise independence.
        W, P = grid.n_workloads, grid.n_points
        block = max(1, cache.block_cells // max(W, 1))
        parts = []
        for lo in range(0, P, block):
            hi = min(lo + block, P)
            key = f"points-{lo:010d}-{hi:010d}"
            d = cache.load_chunk(self, key)
            if d is not None:
                part = EvalResult.from_dict(d)
            else:
                part = evaluate(grid.subset(lo, hi), **kw)
                cache.store_chunk(self, key, _jsonify(part.to_dict()))
            parts.append(part)
        return EvalResult.concat(grid, parts)

    def _run_evaluate(self, stream, cache: ResultCache | None = None) -> dict:
        res = self._evaluate(stream, cache=cache)
        mask = self.constraints.mask(res)
        return {
            "result": res,
            "constraint_mask": mask,
            "n_valid": int(res.valid.sum()),
            "n_feasible": int(mask.sum()),
        }

    def _run_roofline(self, stream, cache: ResultCache | None = None) -> dict:
        """Bandwidth-aware evaluate + per-point bound classification.

        Same engine pass (and the same chunked/cached/sharded execution
        paths) as ``'evaluate'`` — the bandwidth spec is mandatory, so
        the payload additionally carries the bound histogram over valid
        points and the aggregate stall share of total runtime."""
        payload = self._run_evaluate(stream, cache=cache)
        res = payload["result"]
        v = res.valid
        payload["bound_counts"] = {
            name: int(np.sum(v & (np.asarray(res.bound) == name)))
            for name in BOUND_NAMES
        }
        cycles_total = float(np.sum(res.cycles[v]))
        stall_total = float(np.sum(np.where(v, res.stall_cycles, 0.0)))
        payload["stall_cycles_total"] = stall_total
        payload["stall_frac"] = stall_total / cycles_total if cycles_total else 0.0
        return payload

    def _run_search(self, stream, cache: ResultCache | None = None) -> dict:
        """Guided Pareto search (see ``core.search``): each generation is
        one vectorized engine batch and one set of cache chunks, so
        ``--resume`` replays finished generations bit-for-bit and
        ``analysis.workers`` farms missing blocks to N processes."""
        return run_search(self, stream, cache=cache)

    def _run_calibrate(self, stream, cache: ResultCache | None = None) -> dict:
        """Measure + fit (see ``core.calibrate``) on ``analysis.device``
        (``None``: the card). The workload stream is unused — the
        calibration grid is the workload. Each measured shape is one
        cache chunk, keyed by index, label and the device measured on
        (``calibrate_chunk_key``): an interrupted sweep resumes at the
        first unmeasured shape, and timings from one device are never
        replayed as another's. The fit is deterministic given the
        measured rows, so a fully-cached re-run reproduces the artifact
        bit-for-bit."""
        del stream
        spec = self.analysis.calibrate
        dev = resolve_device(self.analysis.device)
        measured = []
        for i, row in enumerate(_calibrate.shape_grid(spec)):
            key = calibrate_chunk_key(i, row, dev)
            d = cache.load_chunk(self, key) if cache is not None else None
            if d is None:
                d = _calibrate.measure_row(
                    row, reps=spec.reps, warmup=spec.warmup, seed=spec.seed,
                    device=dev,
                )
                if cache is not None:
                    cache.store_chunk(self, key, _jsonify(d))
            measured.append(d)
        return _calibrate.fit_rows(measured, spec)

    def _run_serve(self, stream, cache: ResultCache | None = None) -> dict:
        """Serving-traffic simulation (see ``core.serve``): per design
        point, derive the fixed array and step the seeded request queue,
        pricing every step through the bandwidth-aware engine. Point
        blocks are the cache chunks — per-point state is elementwise,
        so ``--resume`` recomputes exactly the missing points with a
        bit-identical stitched payload."""
        return run_serve(self, stream, cache=cache)

    def _run_pareto(self, stream, cache: ResultCache | None = None) -> dict:
        payload = self._run_evaluate(stream, cache=cache)
        res, mask = payload["result"], payload["constraint_mask"]
        res_f = (
            dataclasses.replace(res, within_thermal_budget=mask)
            if self.constraints.has_caps
            else res
        )
        payload["pareto_mask"] = res_f.pareto_mask(
            self.analysis.objectives,
            feasible_only=self.constraints.require_feasible,
        )
        payload["objectives"] = list(self.analysis.objectives)
        return payload

    def _run_schedule(self, stream, cache: ResultCache | None = None) -> dict:
        if self.space.rows is not None:
            raise ValueError("schedule searches array shapes; drop rows/cols")
        if self.constraints.has_caps:
            raise ValueError(
                "schedule supports the thermal constraint only; drop the caps"
            )
        for name in ("dataflow", "tech"):
            if not isinstance(getattr(self.space, name), str):
                raise ValueError(f"schedule needs a single {name}, not a per-point array")
        # schedule's two passes couple all layers (the candidate set is
        # derived from every per-layer optimum), so it caches as one unit.
        if cache is not None:
            d = cache.load_chunk(self, "schedule")
            if d is not None:
                return _restore_payload("schedule", d)
        kw = {}
        if self.analysis.chunk is not None:
            kw["chunk"] = self.analysis.chunk
        if self.analysis.policies is not None:
            kw["policies"] = self.analysis.policies
        rep = schedule(
            stream,
            mac_budgets=self.space.mac_budgets,
            tiers=self.space.tiers,
            dataflow=self.space.dataflow,
            tech=self.space.tech,
            backend=self.analysis.backend,
            device=self.analysis.device,
            thermal_limit=self.constraints.thermal_limit_c,
            require_feasible=self.constraints.require_feasible,
            shard=self.analysis.shard,
            bandwidth=self.analysis.bandwidth,
            thermal=self.analysis.thermal,
            dvfs=self.analysis.dvfs,
            **kw,
        )
        payload = {"report": rep}
        if cache is not None:
            cache.store_chunk(self, "schedule", _jsonify(payload))
        return payload

    def _run_advise(self, stream, cache: ResultCache | None = None) -> dict:
        from .advisor import _rank  # deferred: advisor's shim imports Study

        if self.constraints.has_caps:
            raise ValueError(
                "advise supports the thermal constraint only; drop the caps"
            )
        if not isinstance(self.space.tech, str):
            raise ValueError("advise needs a single tech, not a per-point array")
        if cache is not None:
            d = cache.load_chunk(self, "advise")
            if d is not None:
                return _restore_payload("advise", d)
        params = dict(self.analysis.params)
        bw = self.analysis.bandwidth
        if bw is not None and math.isfinite(bw.dram_gbs):
            # The mesh advisor's memory term is its HBM model [bytes/s];
            # a finite DRAM cap maps straight onto it (an explicit
            # params['hbm_bw'] still wins).
            params.setdefault("hbm_bw", bw.dram_gbs * 1e9)
        names, totals = _rank(
            stream.workloads,
            self.analysis.axis,
            mac_budget=self.analysis.mac_budget,
            tech=self.space.tech,
            thermal_limit=self.constraints.thermal_limit_c,
            **params,
        )
        payload = {
            "strategies": list(MESH_STRATEGIES),
            "names": names,
            "totals": totals,
            "axis": self.analysis.axis,
        }
        if cache is not None:
            cache.store_chunk(self, "advise", _jsonify(payload))
        return payload

    def _run_sweep(self, stream, cache: ResultCache | None = None) -> dict:
        fig = self.analysis.figure
        budgets, tiers = self.space.mac_budgets, self.space.tiers
        if budgets is None or self.space.rows is not None or self.space.layout != "product":
            raise ValueError(
                "sweep figures need a product space (mac_budgets x tiers, "
                "no explicit rows/cols)"
            )
        if self.constraints != ConstraintSpec():
            raise ValueError(
                "sweep figures reproduce the paper's unconstrained sweeps; "
                "drop the non-default constraints (use kind='evaluate' or "
                "'pareto' for constrained studies)"
            )
        if fig == "fig7":
            if self.space.dataflow != "dos":
                raise ValueError(
                    "the fig7 optimal-tier search is defined for the dOS "
                    "dataflow only"
                )
            max_tiers = max(tiers)
            if tiers != tuple(range(1, max_tiers + 1)):
                raise ValueError("fig7 sweeps tiers 1..max; use tiers=range(1, T+1)")
            best, best_cycles = self._fig7_tiers(stream, budgets, max_tiers, cache)
            return {
                "mac_budgets": list(budgets),
                "max_tiers": max_tiers,
                "optimal_tiers": best,
                "best_cycles": best_cycles,
                "medians": [float(np.median(best[:, bi])) for bi in range(len(budgets))],
            }
        # fig5/fig6: one perf-only evaluate over the product grid,
        # reshaped (workload, budget, tier) — budget-major point order.
        res = self._evaluate(stream, metrics=("perf",), cache=cache)
        W = stream.workloads.shape[0]
        speedup = res.speedup.reshape(W, len(budgets), len(tiers))
        return {
            "mac_budgets": list(budgets),
            "tiers": list(tiers),
            "workloads": stream.workloads.tolist(),
            "speedup": speedup,
        }

    def _fig7_tiers(self, stream, budgets, max_tiers: int, cache: ResultCache | None):
        """The fig7 optimal-tier search, chunked over *workloads*.

        Each workload's argmin is independent of every other workload,
        so workload-blocks are the natural cache/stream unit for the
        Fig-7-style million-point sweeps.
        """
        kw = dict(max_tiers=max_tiers, mode=self.space.mode,
                  backend=self.analysis.backend, shard=self.analysis.shard,
                  device=self.analysis.device)
        if self.analysis.bandwidth is not None:
            if not isinstance(self.space.tech, str):
                raise ValueError(
                    "a bandwidth-aware fig7 sweep needs a single tech "
                    "(the derived vertical-link width is per-technology)"
                )
            kw.update(bandwidth=self.analysis.bandwidth, tech=self.space.tech)
        wl = np.atleast_2d(np.asarray(stream.workloads, dtype=np.int64))
        if cache is None:
            return optimal_tiers_batched(wl, budgets, **kw)
        W = wl.shape[0]
        width = max(1, len(budgets) * max_tiers)
        block = max(1, cache.block_cells // width)
        bs, cs = [], []
        for lo in range(0, W, block):
            hi = min(lo + block, W)
            key = f"workloads-{lo:010d}-{hi:010d}"
            d = cache.load_chunk(self, key)
            if d is None:
                b_, c_ = optimal_tiers_batched(wl[lo:hi], budgets, **kw)
                cache.store_chunk(
                    self, key,
                    _jsonify({"optimal_tiers": b_, "best_cycles": c_}),
                )
            else:
                b_ = np.asarray(d["optimal_tiers"], dtype=np.int64)
                c_ = np.asarray(d["best_cycles"], dtype=np.float64)
            bs.append(b_)
            cs.append(c_)
        return np.concatenate(bs, axis=0), np.concatenate(cs, axis=0)

    # -- convenience --------------------------------------------------------

    @classmethod
    def example(cls, kind: str = "evaluate") -> "Study":
        """A small runnable template spec per analysis kind (the CLI's
        ``example-spec`` source — each finishes in seconds)."""
        validate_option("analysis kind", kind, ANALYSIS_KINDS)
        gemms = ((64, 12100, 147), (512, 784, 128))
        space = SpaceSpec(mac_budgets=(2**14, 2**16), tiers=tuple(range(1, 9)))
        if kind == "schedule":
            return cls(
                name="example-schedule",
                workload=WorkloadSpec(kind="network", arch="smollm-135m",
                                      shape="decode_32k"),
                space=space,
                analysis=AnalysisSpec(kind="schedule"),
            )
        if kind == "advise":
            return cls(
                name="example-advise",
                workload=WorkloadSpec(kind="gemms", gemms=gemms),
                analysis=AnalysisSpec(kind="advise", axis=16, mac_budget=2**16),
            )
        if kind == "sweep":
            return cls(
                name="example-sweep-fig5",
                workload=WorkloadSpec(kind="gemms",
                                      gemms=((64, 255, 147), (64, 12100, 147))),
                space=space,
                analysis=AnalysisSpec(kind="sweep", figure="fig5"),
            )
        if kind == "roofline":
            return cls(
                name="example-roofline",
                workload=WorkloadSpec(kind="gemms", gemms=gemms),
                space=space,
                analysis=AnalysisSpec(
                    kind="roofline", bandwidth=BandwidthSpec.paper_default()
                ),
            )
        if kind == "calibrate":
            # the workload is a placeholder (calibrate ignores it —
            # the shape grid is the workload); smoke preset + low reps
            # keep the example in CI-seconds territory.
            return cls(
                name="example-calibrate",
                workload=WorkloadSpec(kind="gemms", gemms=gemms),
                analysis=AnalysisSpec(
                    kind="calibrate",
                    calibrate=CalibrateSpec(preset="smoke", reps=2, warmup=1),
                ),
            )
        if kind == "serve":
            return cls(
                name="example-serve",
                workload=WorkloadSpec(kind="network", arch="smollm-135m",
                                      shape="decode_32k"),
                space=SpaceSpec(mac_budgets=(2**14, 2**16), tiers=(1, 4, 8)),
                analysis=AnalysisSpec(
                    kind="serve",
                    bandwidth=BandwidthSpec.paper_default(),
                    serve=ServeSpec(
                        traffic=TrafficSpec(
                            arrival_rps=2048.0,
                            n_requests=8,
                            prompt_mean=64,
                            prompt_max=256,
                            output_mean=8,
                            output_max=32,
                            max_batch=4,
                            chunk_prefill=32,
                            seed=0,
                        )
                    ),
                ),
            )
        if kind == "search":
            return cls(
                name="example-search",
                workload=WorkloadSpec(kind="gemms", gemms=gemms),
                space=SpaceSpec(
                    mac_budgets=tuple(2**k for k in range(10, 19)),
                    tiers=tuple(range(1, 9)),
                    dataflow=("dos", "ws"),
                    tech=("tsv", "miv"),
                ),
                analysis=AnalysisSpec(
                    kind="search",
                    bandwidth=BandwidthSpec.paper_default(),
                    search=SearchSpec(
                        objectives=("cycles", "energy_j"),
                        generations=4,
                        population=64,
                        refine=(4, 2, 1),
                        seed=0,
                        dram_gbs=(64.0, 128.0, 256.0, 512.0),
                        sram_kib=(256.0, 512.0, 1024.0),
                    ),
                ),
            )
        return cls(
            name=f"example-{kind}",
            workload=WorkloadSpec(kind="gemms", gemms=gemms),
            space=space,
            analysis=AnalysisSpec(kind=kind),
        )


def calibrate_chunk_key(i: int, row: dict, device) -> str:
    """The cache chunk key of calibration row ``i`` measured on
    ``device``: index, label and the device's name (``cpu``, or the
    card's, e.g. ``NVIDIA_H100_80GB_HBM3``)."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return f"shape-{i:04d}-{row['label']}-{re.sub(r'[^A-Za-z0-9.]+', '_', name)}"


# ---------------------------------------------------------------------------
# The artifact
# ---------------------------------------------------------------------------

def _restore_payload(kind: str, payload: dict) -> dict:
    """Re-type a JSON-decoded payload (inverse of ``_jsonify``)."""
    out = dict(payload)
    if "result" in out and not isinstance(out["result"], EvalResult):
        out["result"] = EvalResult.from_dict(out["result"])
    if "report" in out and not isinstance(out["report"], NetworkReport):
        out["report"] = NetworkReport.from_dict(out["report"])
    for key, dt in (
        ("constraint_mask", bool),
        ("pareto_mask", bool),
        ("totals", np.float64),
        ("speedup", np.float64),
        ("best_cycles", np.float64),
        ("optimal_tiers", np.int64),
        ("frontier_candidates", np.int64),
        ("frontier_objectives", np.float64),
    ):
        if key in out and not isinstance(out[key], np.ndarray):
            out[key] = np.asarray(out[key], dtype=dt)
    if kind == "advise" and not isinstance(out.get("names"), np.ndarray):
        out["names"] = np.asarray(out["names"])
    if kind == "calibrate" and isinstance(out.get("artifact"), dict):
        out["artifact"] = CalibratedBandwidth.from_dict(out["artifact"])
    if kind == "serve" and isinstance(out.get("points"), dict):
        out["points"] = restore_points(out["points"])
    return out


@dataclasses.dataclass(frozen=True)
class StudyResult:
    """Versioned, serializable result artifact: inputs echoed + payload.

    ``payload`` is kind-specific and array-backed in memory (see the
    module docstring); ``to_dict``/``to_json`` give the JSON form and
    ``from_dict``/``from_json``/``load`` restore the typed objects.
    """

    study: Study
    kind: str
    payload: dict
    version: int = SPEC_VERSION
    #: cache hit/miss counters when the run was cache-backed (else None).
    cache: dict | None = None

    # typed accessors ------------------------------------------------------
    @property
    def result(self) -> EvalResult | None:
        """The batched ``EvalResult`` (evaluate/pareto kinds)."""
        return self.payload.get("result")

    @property
    def report(self) -> NetworkReport | None:
        """The ``NetworkReport`` (schedule kind)."""
        return self.payload.get("report")

    def to_dict(self) -> dict:
        out = {
            "version": self.version,
            "kind": self.kind,
            "study": self.study.to_dict(),
            "payload": _jsonify(self.payload),
        }
        if self.cache is not None:
            out["cache"] = _jsonify(self.cache)
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "StudyResult":
        version = int(d.get("version", SPEC_VERSION))
        if version > SPEC_VERSION:
            raise ValueError(
                f"artifact version {version} is newer than supported {SPEC_VERSION}"
            )
        kind = str(d["kind"])
        return cls(
            study=Study.from_dict(d["study"]),
            kind=kind,
            payload=_restore_payload(kind, d["payload"]),
            version=version,
            cache=d.get("cache"),
        )

    def to_json(self, indent: int | None = 1) -> str:
        # allow_nan=False: artifacts are strict JSON; non-finite values
        # travel as the _jsonify string encoding instead
        return json.dumps(self.to_dict(), indent=indent, allow_nan=False)

    @classmethod
    def from_json(cls, s: str) -> "StudyResult":
        return cls.from_dict(json.loads(s))

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path) -> "StudyResult":
        return cls.from_json(pathlib.Path(path).read_text())

    def describe(self) -> str:
        """One-line human summary (what the CLI prints)."""
        name = self.study.name or "<unnamed>"
        if self.kind == "search":
            p = self.payload
            return (
                f"{name}: search {p['n_evaluated']:,}/{p['space_size']:,} "
                f"points ({p['frac_evaluated']:.3%}) over "
                f"{p['generations']} generations — "
                f"{len(p['frontier_objectives'])} on the feasible frontier, "
                f"hypervolume {p['hypervolume']:.4e}"
            )
        if self.kind == "calibrate":
            p = self.payload
            e = p["errors"]
            eff = ", ".join(
                f"{k}: {v:.2%}" for k, v in sorted(p["efficiency"].items())
            )
            return (
                f"{name}: calibrate {len(p['rows'])} shapes — "
                f"dram {p['dram_gbs_fitted']:.2f} GB/s, efficiency {eff}; "
                f"holdout err {e['holdout_median_rel_err']:.1%} "
                f"(uncalibrated {e['uncalibrated_holdout_median_rel_err']:.1%})"
            )
        if self.kind == "serve":
            p = self.payload
            s = p["summary"]
            best = s["best_3d"] or s["best_2d"]
            head = (
                f"{name}: serve {p['trace']['n_requests']} requests x "
                f"{p['n_points']} design points on {p['arch']} — "
                f"{s['n_feasible']} feasible"
            )
            if best is None:
                return head + ", no servable design"
            d = best["design"]
            head += (
                f"; best {d[0]}x{d[1]}x{d[2]}/{best['tech']} at "
                f"{best['gen_tok_s']:.3e} tok/s, "
                f"{best['tokens_per_s_per_w']:.3e} tok/s/W"
            )
            if s["win_3d_vs_2d"] is not None:
                head += f" ({s['win_3d_vs_2d']:.2f}x 3D-vs-2D on tok/s/W)"
            return head
        if self.kind == "roofline":
            W, P = self.result.valid.shape
            bc = self.payload["bound_counts"]
            mix = ", ".join(f"{k}: {v}" for k, v in bc.items())
            return (
                f"{name}: roofline {W} workloads x {P} design points — "
                f"bounds {mix}; stalls {self.payload['stall_frac']:.1%} of "
                f"total cycles"
            )
        if self.kind in ("evaluate", "pareto"):
            res = self.result
            W, P = res.valid.shape
            extra = (
                f", {int(self.payload['pareto_mask'].sum())} on the frontier"
                if "pareto_mask" in self.payload
                else ""
            )
            return (
                f"{name}: {self.kind} {W} workloads x {P} design points — "
                f"{self.payload['n_feasible']}/{self.payload['n_valid']} "
                f"valid points feasible{extra}"
            )
        if self.kind == "schedule":
            rep = self.report
            fx = rep.fixed
            d = np.asarray(fx.design).reshape(-1)
            line = (
                f"{name}: schedule {rep.arch}/{rep.shape} — fixed "
                f"{int(d[0])}x{int(d[1])}x{int(d[2])} at {fx.total_cycles:.3e} "
                f"cycles, {fx.speedup_vs_2d:.2f}x vs 2D"
            )
            tf = getattr(rep, "tier_fold", None)
            if tf is not None:
                gain = fx.total_cycles / tf.total_cycles if tf.total_cycles else 1.0
                line += (
                    f"; tier_fold {tf.total_cycles:.3e} cycles "
                    f"({gain:.2f}x vs fixed)"
                )
            return line
        if self.kind == "advise":
            names = np.asarray(self.payload["names"])
            u, c = np.unique(names, return_counts=True)
            mix = ", ".join(f"{n}: {k}" for n, k in zip(u.tolist(), c.tolist()))
            return f"{name}: advise axis={self.payload['axis']} — winners {mix}"
        fig = self.study.analysis.figure
        if fig == "fig7":
            med = ", ".join(f"{m:g}" for m in self.payload["medians"])
            return f"{name}: sweep {fig} — median optimal tiers [{med}]"
        s = np.asarray(self.payload["speedup"], dtype=np.float64)
        with np.errstate(invalid="ignore"):
            peak = float(np.nanmax(s))
        return f"{name}: sweep {fig} — peak 3D-vs-2D speedup {peak:.2f}x"
