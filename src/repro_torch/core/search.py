"""Guided Pareto search: a stable frontier out of a billion-point space.

A numpy copy of the JAX package's ``core/search.py``; the torch backend
enters only through ``engine.evaluate`` (``AnalysisSpec.backend`` and
``device``), and worker processes are spawned (see ``run_search``).

The batched engine prices ~10^5 design points per second, but the full
space it can express — MAC budget x tiers x dataflow x vertical-link
tech x DRAM bandwidth x SRAM capacity — is billions of points.
Exhaustive sweeps stop being an option well before that; this module is
a guided search over such combinatorially large spaces:

- **One batch per generation.** Candidates are index tuples into the
  per-axis value lists, and every generation is exactly one vectorized
  ``engine.evaluate`` call over the proposed batch (the per-point
  ``DesignGrid`` axes — including the PR-6 ``dram_gbs``/``sram_kib``
  memory-system axes — carry heterogeneous candidates in a single
  grid). No per-candidate Python loop ever touches the engine.
- **Successive halving over a coarse-to-fine lattice.** Generation g
  samples the axis lattice at stride ``refine[g]`` (a halving schedule
  like (8, 8, 4, 4, 2, 2, 1, 1)); early generations scan the whole
  space cheaply, later ones resolve fine structure around survivors.
- **Evolutionary proposals.** A fraction of each generation mutates /
  crossbreeds survivors of the running *feasible-only* Pareto archive
  (the frontier of every feasible point evaluated so far), the rest
  keeps exploring the lattice. Proposals are deduped against the
  evaluated-point set, so no point is ever priced twice.
- **Deterministic and resumable.** The PRNG is a single seeded
  ``np.random.default_rng`` threaded explicitly through the proposal
  step; proposals are a pure function of (seed, results so far), so
  identical seeds give bit-identical ``StudyResult`` payloads — also
  across ``--resume`` (each generation's batch is a content-addressed
  cache chunk; replayed chunks reproduce the evaluation bits exactly,
  so the PRNG trajectory re-derives identically) and across any worker
  count (``parallel.work_queue`` farms missing blocks to N processes
  over the same chunk protocol).

On small spaces the proposal step switches to exhaustive enumeration of
the not-yet-seen remainder whenever the whole space fits in the
remaining evaluation budget: with budget >= space size the guided
frontier *equals* the exhaustive feasible frontier.
"""

from __future__ import annotations

import dataclasses
import math
import tempfile

import numpy as np

from .cache import ResultCache
from .engine import DesignGrid, evaluate, pareto_mask_batched
from .params import VALID_FOLDS, VALID_OBJECTIVES, validate_option

__all__ = [
    "SearchSpec",
    "evaluate_candidates",
    "chunk_payload",
    "exhaustive_frontier",
    "hypervolume",
    "resolve_axes",
    "run_search",
]


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """The guided-search configuration (JSON-round-trippable).

    - ``objectives``: minimized ``EvalResult`` metric columns; a design
      point's objective value is the workload-count-weighted sum over
      the study's workloads (one scalar per objective per point).
    - ``generations`` x ``population``: the evaluation budget — each
      generation proposes up to ``population`` unseen candidates and
      prices them in one engine batch.
    - ``refine``: per-generation lattice stride (successive halving);
      shorter than ``generations`` repeats its last entry.
    - ``mutation`` / ``crossover``: fractions of each generation bred
      from the running feasible-only Pareto archive (the remainder
      keeps sampling the stride lattice). Both 0 disables evolution.
    - ``seed``: the explicit PRNG seed — identical seeds give
      bit-identical results (also across ``--resume`` / worker counts).
    - ``dram_gbs`` / ``sram_kib``: optional memory-system axes [GB/s,
      KiB per tier]; they require ``AnalysisSpec.bandwidth`` and ride
      the grid's per-point overrides.
    - ``folds``: optional tier-fold axis ('m'|'k'|'n' — see
      ``analytical.fold_dims``); each candidate commits every layer to
      one fold, riding the grid's per-point ``fold`` override. A
      dataflow's native fold prices identically to no fold at all.
    - ``ref_point``: hypervolume reference (one value per objective);
      ``None`` derives it from the evaluated feasible set (nadir * 1.1).
    """

    objectives: tuple[str, ...] = ("cycles", "energy_j")
    generations: int = 8
    population: int = 256
    refine: tuple[int, ...] = (8, 8, 4, 4, 2, 2, 1, 1)
    mutation: float = 0.4
    crossover: float = 0.3
    seed: int = 0
    dram_gbs: tuple[float, ...] | None = None
    sram_kib: tuple[float, ...] | None = None
    folds: tuple[str, ...] | None = None
    ref_point: tuple[float, ...] | None = None

    def __post_init__(self):
        object.__setattr__(
            self, "objectives",
            tuple(validate_option("objective", o, VALID_OBJECTIVES)
                  for o in self.objectives),
        )
        for name in ("generations", "population", "seed"):
            object.__setattr__(self, name, int(getattr(self, name)))
        if self.generations < 1:
            raise ValueError(f"generations must be >= 1, got {self.generations}")
        if self.population < 1:
            raise ValueError(f"population must be >= 1, got {self.population}")
        if self.seed < 0:
            raise ValueError(f"seed must be >= 0, got {self.seed}")
        refine = tuple(int(s) for s in self.refine)
        if not refine or any(s < 1 for s in refine):
            raise ValueError(f"refine must be positive strides, got {self.refine}")
        object.__setattr__(self, "refine", refine)
        for name in ("mutation", "crossover"):
            object.__setattr__(self, name, float(getattr(self, name)))
        if not (0.0 <= self.mutation <= 1.0 and 0.0 <= self.crossover <= 1.0
                and self.mutation + self.crossover <= 1.0):
            raise ValueError(
                f"mutation ({self.mutation}) and crossover ({self.crossover}) "
                "must be fractions with mutation + crossover <= 1"
            )
        for name in ("dram_gbs", "sram_kib"):
            v = getattr(self, name)
            if v is None:
                continue
            vals = tuple(float(x) for x in v)
            if not vals or any(not math.isfinite(x) or x <= 0 for x in vals):
                raise ValueError(f"{name} axis needs positive finite values, got {v}")
            object.__setattr__(self, name, vals)
        if self.folds is not None:
            object.__setattr__(
                self, "folds",
                tuple(validate_option("fold", f, VALID_FOLDS) for f in self.folds),
            )
        if self.ref_point is not None:
            rp = tuple(float(x) for x in self.ref_point)
            if len(rp) != len(self.objectives) or any(not math.isfinite(x) for x in rp):
                raise ValueError(
                    f"ref_point needs one finite value per objective "
                    f"({len(self.objectives)}), got {self.ref_point}"
                )
            object.__setattr__(self, "ref_point", rp)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SearchSpec":
        return cls(**d)


# ---------------------------------------------------------------------------
# The search space: named axes of values, candidates as index tuples
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Axis:
    name: str
    values: np.ndarray  # 1-D; int64 / float64 / str


def resolve_axes(study) -> list[_Axis]:
    """The study's search axes, in canonical order.

    ``SpaceSpec`` contributes mac_budgets / tiers / dataflow / tech
    (strings become single-value axes); ``SearchSpec`` contributes the
    optional memory-system axes. The effective space is their product —
    candidates are index tuples into these value lists.
    """
    space, spec = study.space, study.analysis.search
    if spec is None:
        raise ValueError("kind='search' needs an AnalysisSpec.search SearchSpec")
    if space.rows is not None:
        raise ValueError(
            "search optimizes over MAC budgets (the engine finds per-tier "
            "shapes); drop the explicit rows/cols"
        )
    if space.mac_budgets is None:
        raise ValueError("search needs SpaceSpec.mac_budgets as an axis")
    if space.layout != "product":
        raise ValueError("search crosses its axes itself; use layout='product'")
    axes = [
        _Axis("mac_budgets", np.asarray(space.mac_budgets, dtype=np.int64)),
        _Axis("tiers", np.asarray(space.tiers, dtype=np.int64)),
    ]
    for name in ("dataflow", "tech"):
        v = getattr(space, name)
        axes.append(_Axis(name, np.asarray([v] if isinstance(v, str) else list(v))))
    for name in ("dram_gbs", "sram_kib"):
        v = getattr(spec, name)
        if v is not None:
            axes.append(_Axis(name, np.asarray(v, dtype=np.float64)))
    if spec.folds is not None:
        axes.append(_Axis("fold", np.asarray(list(spec.folds))))
    for ax in axes:
        if len(np.unique(ax.values)) != ax.values.shape[0]:
            raise ValueError(
                f"search axis {ax.name!r} has duplicate values — the space "
                "product would double-count points"
            )
    return axes


def _candidate_grid(study, stream, axes: list[_Axis], cands: np.ndarray) -> DesignGrid:
    """Index rows -> ONE heterogeneous DesignGrid (a single engine batch)."""
    vals = {ax.name: ax.values[cands[:, i]] for i, ax in enumerate(axes)}
    kw: dict = {
        "workloads": stream.workloads,
        "tiers": vals["tiers"],
        "mac_budgets": vals["mac_budgets"],
        "dataflow": vals["dataflow"],
        "tech": vals["tech"],
        "mode": study.space.mode,
    }
    for name in ("dram_gbs", "sram_kib", "fold"):
        if name in vals:
            kw[name] = vals[name]
    return DesignGrid(**kw)


def evaluate_candidates(study, cands, stream=None, axes=None):
    """Price one candidate batch: one vectorized ``engine.evaluate``.

    Returns ``(objectives, feasible)`` — (n, n_obj) float64 of
    count-weighted objective sums and (n,) bool of all-workloads
    feasibility under the study's constraints. This is the work unit
    the multi-process queue farms out; it is deterministic, so chunk
    payloads are bit-identical across processes and worker counts.
    """
    a = study.analysis
    spec = a.search
    if stream is None:
        stream = study.workload.resolve()
    if axes is None:
        axes = resolve_axes(study)
    cands = np.asarray(cands, dtype=np.int64)
    grid = _candidate_grid(study, stream, axes, cands)
    res = evaluate(
        grid,
        metrics=a.metrics,
        backend=a.backend,
        thermal_limit=study.constraints.thermal_limit_c,
        shard=a.shard,
        bandwidth=a.bandwidth,
        device=a.device,
        **({"chunk": a.chunk} if a.chunk is not None else {}),
    )
    mask = study.constraints.mask(res)
    feasible = mask.all(axis=0)
    counts = np.asarray(stream.counts, dtype=np.float64)
    cols = []
    for name in spec.objectives:
        v = getattr(res, name)
        if v is None:
            raise ValueError(
                f"objective {name!r} was not evaluated — add its metric "
                "group to AnalysisSpec.metrics"
            )
        with np.errstate(invalid="ignore"):
            cols.append((counts[:, None] * np.asarray(v, dtype=np.float64)).sum(axis=0))
    return np.stack(cols, axis=1), feasible


def chunk_payload(cands: np.ndarray, objs: np.ndarray, feasible: np.ndarray) -> dict:
    """The JSON chunk form of one evaluated block (cache / wire format).

    Candidates are stored alongside the results and verified on load —
    a chunk whose candidate rows do not match the deterministic
    re-proposal is recomputed, never silently trusted.
    """
    from .study import _jsonify  # deferred: study imports this module

    return {
        "candidates": np.asarray(cands, dtype=np.int64).tolist(),
        "objectives": _jsonify(np.asarray(objs, dtype=np.float64)),
        "feasible": np.asarray(feasible, dtype=bool).tolist(),
    }


def _decode_chunk(d: dict):
    objs = np.asarray(d["objectives"], dtype=np.float64)
    feas = np.asarray(d["feasible"], dtype=bool)
    return objs, feas


# ---------------------------------------------------------------------------
# Proposals: lattice exploration + evolution over the Pareto archive
# ---------------------------------------------------------------------------

def _propose(rng, spec: SearchSpec, sizes, stride: int, archive_X, seen,
             remaining_budget: int) -> np.ndarray:
    """Up to ``population`` unseen candidate index rows for one generation.

    Pure function of (rng state, archive, seen): re-running a resumed
    search re-derives the identical proposal sequence. When the whole
    space fits in the remaining budget the proposal degrades to
    exhaustive enumeration of the unseen remainder (completeness on
    small spaces — the property tests' guarantee).
    """
    n_axes = len(sizes)
    total = math.prod(sizes)
    pop = spec.population
    unseen = total - len(seen)
    if unseen <= 0:
        return np.empty((0, n_axes), dtype=np.int64)
    if total <= remaining_budget or unseen <= pop:
        out = []
        for flat in range(total):
            c = tuple(int(x) for x in np.unravel_index(flat, sizes))
            if c not in seen:
                out.append(c)
                if len(out) == pop:
                    break
        return np.asarray(out, dtype=np.int64).reshape(len(out), n_axes)

    n_arch = archive_X.shape[0]
    n_mut = int(round(pop * spec.mutation)) if n_arch >= 1 else 0
    n_cross = int(round(pop * spec.crossover)) if n_arch >= 2 else 0
    n_explore = pop - n_mut - n_cross
    lattice = np.asarray([-(-s // stride) for s in sizes], dtype=np.int64)
    hi = np.asarray(sizes, dtype=np.int64) - 1

    chosen: dict[tuple, None] = {}
    for _ in range(12):  # bounded retry: dedupe may reject whole batches
        need = pop - len(chosen)
        if need <= 0:
            break
        parts = []
        if n_explore:
            parts.append(rng.integers(0, lattice, size=(n_explore, n_axes)) * stride)
        if n_mut:
            parents = archive_X[rng.integers(0, n_arch, size=n_mut)]
            step = rng.integers(-2, 3, size=(n_mut, n_axes)) * stride
            flip = rng.random((n_mut, n_axes)) < 0.5
            parts.append(np.clip(parents + np.where(flip, step, 0), 0, hi))
        if n_cross:
            pa = archive_X[rng.integers(0, n_arch, size=n_cross)]
            pb = archive_X[rng.integers(0, n_arch, size=n_cross)]
            mix = rng.random((n_cross, n_axes)) < 0.5
            parts.append(np.where(mix, pa, pb))
        batch = np.concatenate(parts, axis=0)
        for row in batch:
            t = tuple(int(x) for x in row)
            if t not in seen and t not in chosen:
                chosen[t] = None
                if len(chosen) == pop:
                    break
    return np.asarray(list(chosen), dtype=np.int64).reshape(len(chosen), n_axes)


# ---------------------------------------------------------------------------
# Hypervolume (minimization; exact)
# ---------------------------------------------------------------------------

def hypervolume(points, ref) -> float:
    """Dominated hypervolume of a minimized point set w.r.t. ``ref``.

    Exact: O(n log n) sweep for 2 objectives, recursive slicing over the
    first coordinate (HSO-style) for d >= 3. Points not strictly better
    than ``ref`` in every objective contribute nothing and are dropped;
    non-finite points never contribute.
    """
    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    ref = np.asarray(ref, dtype=np.float64).reshape(-1)
    if pts.shape[0] == 0:
        return 0.0
    if pts.shape[1] != ref.shape[0]:
        raise ValueError(f"ref has {ref.shape[0]} coords for {pts.shape[1]}-d points")
    keep = np.isfinite(pts).all(axis=1) & (pts < ref).all(axis=1)
    pts = pts[keep]
    if pts.shape[0] == 0:
        return 0.0
    pts = pts[pareto_mask_batched(pts[None])[0]]
    return _hv(pts, ref)


def _hv(pts: np.ndarray, ref: np.ndarray) -> float:
    d = pts.shape[1]
    if d == 1:
        return float(ref[0] - pts.min())
    if d == 2:
        order = np.lexsort((pts[:, 1], pts[:, 0]))
        p = pts[order]
        hv, prev_y = 0.0, float(ref[1])
        for x, y in p:
            hv += (ref[0] - x) * (prev_y - y)
            prev_y = y
        return float(hv)
    order = np.argsort(pts[:, 0], kind="stable")
    p = pts[order]
    xs = p[:, 0]
    hv = 0.0
    for i in range(p.shape[0]):
        x_hi = xs[i + 1] if i + 1 < xs.shape[0] else ref[0]
        width = float(x_hi - xs[i])
        if width <= 0.0:
            continue
        sub = p[: i + 1, 1:]
        sub = sub[pareto_mask_batched(sub[None])[0]]
        hv += width * _hv(sub, ref[1:])
    return float(hv)


# ---------------------------------------------------------------------------
# The search loop
# ---------------------------------------------------------------------------

def run_search(study, stream, cache: ResultCache | None = None) -> dict:
    """Execute a ``kind='search'`` study; returns the payload dict.

    Cached execution chunks each generation's batch into cache blocks
    keyed ``search-gen####-lo-hi`` (worker-count-independent), so
    ``--resume`` replays finished generations with zero recomputation
    and an interrupted generation resumes at block granularity. With
    ``AnalysisSpec.workers > 1`` the missing blocks of each generation
    are farmed to worker processes over the same chunk protocol
    (``parallel.work_queue``); an ephemeral cache carries the chunks
    when the run itself is uncached. The workers are spawned, not
    forked (a forked child cannot use CUDA once the parent has), at the
    first generation with missing blocks, and serve every later one.
    """
    a = study.analysis
    spec: SearchSpec = a.search
    axes = resolve_axes(study)
    sizes = [int(ax.values.shape[0]) for ax in axes]
    total = math.prod(sizes)
    rng = np.random.default_rng(spec.seed)
    workers = int(a.workers) if a.workers else 1
    W = int(np.atleast_2d(stream.workloads).shape[0])

    tmp = None
    pool = None
    if workers > 1:
        from ..parallel.work_queue import WorkerPool

        pool = WorkerPool(workers)
    if workers > 1 and cache is None:
        # the queue's transport is the chunk store; give it a scratch one
        tmp = tempfile.TemporaryDirectory(prefix="repro-workqueue-")
        cache = ResultCache(tmp.name)
        cache.prepare(study)
    try:
        seen: dict[tuple, None] = {}
        n_obj = len(spec.objectives)
        all_X: list[np.ndarray] = []
        all_F: list[np.ndarray] = []
        archive_X = np.empty((0, len(axes)), dtype=np.int64)
        archive_F = np.empty((0, n_obj), dtype=np.float64)
        n_feasible = 0
        history = []
        for g in range(spec.generations):
            stride = spec.refine[min(g, len(spec.refine) - 1)]
            remaining = spec.population * (spec.generations - g)
            cands = _propose(rng, spec, sizes, stride, archive_X, seen, remaining)
            if cands.shape[0]:
                objs, feas = _evaluate_generation(
                    study, stream, axes, cands, g, cache, pool, W
                )
                for row in cands:
                    seen[tuple(int(x) for x in row)] = None
                n_feasible += int(feas.sum())
                if feas.any():
                    all_X.append(cands[feas])
                    all_F.append(objs[feas])
                    ax_cat = np.concatenate([archive_X, cands[feas]])
                    af_cat = np.concatenate([archive_F, objs[feas]])
                    m = pareto_mask_batched(af_cat[None])[0]
                    archive_X, archive_F = ax_cat[m], af_cat[m]
            history.append({
                "generation": g,
                "stride": int(stride),
                "n_proposed": int(cands.shape[0]),
                "n_evaluated_total": len(seen),
                "n_feasible_total": n_feasible,
                "frontier_size": int(archive_X.shape[0]),
            })

        if spec.ref_point is not None:
            ref = np.asarray(spec.ref_point, dtype=np.float64)
        elif archive_F.shape[0]:
            feas_F = np.concatenate(all_F) if all_F else archive_F
            finite = feas_F[np.isfinite(feas_F).all(axis=1)]
            nad = finite.max(axis=0) if finite.shape[0] else archive_F.max(axis=0)
            ref = np.where(nad > 0, nad * 1.1, nad + 1.0)
        else:
            ref = None
        hv = hypervolume(archive_F, ref) if ref is not None else 0.0

        order = np.lexsort(archive_F.T[::-1]) if archive_F.shape[0] else np.empty(0, int)
        frontier_X, frontier_F = archive_X[order], archive_F[order]
        return {
            "objectives": list(spec.objectives),
            "axes": {ax.name: ax.values.tolist() for ax in axes},
            "axis_names": [ax.name for ax in axes],
            "space_size": int(total),
            "n_evaluated": len(seen),
            "frac_evaluated": len(seen) / total if total else 0.0,
            "n_feasible": n_feasible,
            "frontier_candidates": frontier_X,
            "frontier_objectives": frontier_F,
            "frontier_designs": {
                ax.name: ax.values[frontier_X[:, i]].tolist()
                for i, ax in enumerate(axes)
            },
            "hypervolume": float(hv),
            "ref_point": None if ref is None else [float(x) for x in ref],
            "generations": spec.generations,
            "history": history,
        }
    finally:
        if pool is not None:
            pool.close()
        if tmp is not None:
            tmp.cleanup()


def _evaluate_generation(study, stream, axes, cands, g: int, cache, pool, W: int):
    """One generation's batch through the (cached, possibly multi-process)
    chunk protocol; merged results are block-layout-independent."""
    n = cands.shape[0]
    block = n if cache is None else max(1, cache.block_cells // max(W, 1))
    blocks = []
    jobs = []
    parts: dict[str, dict] = {}
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        key = f"search-gen{g:04d}-{lo:08d}-{hi:08d}"
        blocks.append((key, lo, hi))
        if cache is not None:
            d = cache.load_chunk(study, key)
            if d is not None and d.get("candidates") == cands[lo:hi].tolist():
                parts[key] = d
                continue
        jobs.append((key, lo, hi))
    if jobs and pool is not None:
        pool.run(
            study.to_json(indent=None),
            str(cache.root),
            cache.block_cells,
            [(key, cands[lo:hi].tolist()) for key, lo, hi in jobs],
        )
        for key, lo, hi in jobs:
            d = cache.peek_chunk(study, key)
            if d is None:
                raise RuntimeError(f"work queue produced no chunk for {key}")
            parts[key] = d
    elif jobs:
        for key, lo, hi in jobs:
            objs, feas = evaluate_candidates(
                study, cands[lo:hi], stream=stream, axes=axes
            )
            payload = chunk_payload(cands[lo:hi], objs, feas)
            if cache is not None:
                cache.store_chunk(study, key, payload)
            parts[key] = payload
    objs_parts, feas_parts = [], []
    for key, lo, hi in blocks:
        o, f = _decode_chunk(parts[key])
        objs_parts.append(o)
        feas_parts.append(f)
    return np.concatenate(objs_parts, axis=0), np.concatenate(feas_parts, axis=0)


# ---------------------------------------------------------------------------
# Exhaustive reference (validation subspaces, property tests, the bench)
# ---------------------------------------------------------------------------

def exhaustive_frontier(study, stream=None, block: int = 1 << 14) -> dict:
    """Price EVERY point of the study's search space (streamed in
    blocks); returns the exact feasible frontier and bookkeeping.

    The reference the guided search is validated against — tractable up
    to ~1e6-point subspaces at the engine's batch throughput.
    """
    if stream is None:
        stream = study.workload.resolve()
    axes = resolve_axes(study)
    sizes = [int(ax.values.shape[0]) for ax in axes]
    total = math.prod(sizes)
    feas_X: list[np.ndarray] = []
    feas_F: list[np.ndarray] = []
    n_feasible = 0
    for lo in range(0, total, block):
        hi = min(lo + block, total)
        flat = np.arange(lo, hi)
        cands = np.stack(np.unravel_index(flat, sizes), axis=1).astype(np.int64)
        objs, feas = evaluate_candidates(study, cands, stream=stream, axes=axes)
        n_feasible += int(feas.sum())
        if feas.any():
            # frontier-reduce incrementally: memory stays O(frontier)
            feas_X.append(cands[feas])
            feas_F.append(objs[feas])
            X = np.concatenate(feas_X)
            F = np.concatenate(feas_F)
            m = pareto_mask_batched(F[None])[0]
            feas_X, feas_F = [X[m]], [F[m]]
    X = feas_X[0] if feas_X else np.empty((0, len(axes)), dtype=np.int64)
    F = feas_F[0] if feas_F else np.empty((0, len(study.analysis.search.objectives)))
    order = np.lexsort(F.T[::-1]) if F.shape[0] else np.empty(0, int)
    return {
        "space_size": total,
        "n_feasible": n_feasible,
        "frontier_candidates": X[order],
        "frontier_objectives": F[order],
    }
