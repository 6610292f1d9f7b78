"""Serving-traffic engine: price a request stream on every design point.

A numpy copy of the JAX package's ``core/serve.py`` (the simulator, not
the model server ``launch/serve.py``); the torch backend enters only
through the fixed-design search (``engine.evaluate`` with the study's
``backend`` and ``device``).

The paper's 9.14x 3D-vs-2D headline is a single-GEMM peak number; the
question production cares about is *sustained*: how many users does one
3D stack serve when the workload is a mix of compute-bound prefill
bursts and bandwidth-bound decode steps under continuous batching?
This module answers it with the pieces the repo already has:

- ``TrafficSpec``: a seeded, JSON-round-trippable request workload —
  Poisson arrivals at ``arrival_rps``, prompt/output length
  distributions (fixed | uniform | lognormal, truncated to
  ``[1, *_max]``), a ``max_batch`` admission cap, the batching
  ``policy`` ('continuous' | 'static') and a ``chunk_prefill`` token
  budget that interleaves long prompts with running decodes.
- ``ServeSpec``: ties the traffic to the study's model-zoo workload
  (the network is re-lowered per *step token*: one batched decode-step
  GEMM stream with M left symbolic) and to the simulator knobs
  (kv-cache word size, the representative step size the fixed-array
  design search uses, a step-count safety cap).
- ``run_serve``: the ``kind='serve'`` executor. Per design point of
  the study's ``SpaceSpec`` grid it (1) derives the fixed (R, C, L)
  array exactly like ``engine.schedule`` — per-layer optima at a
  representative step, candidates re-evaluated explicitly, the
  count-weighted-best feasible candidate wins — then (2) steps the
  batched request queue (admit -> chunked prefill -> interleaved
  decode -> retire), pricing every step with one vectorized call into
  the shared frequency-aware step pricer (``core.pricing.price_steps``
  over all layers x design points at once), and (3) reduces to
  tokens/s, p50/p99 TTFT, p50/p99 per-output-token latency,
  energy/token and tokens/s/W per design point.

Pricing conventions (documented modeling choices):

- A step with ``m`` total tokens (prefill-chunk tokens + one token per
  running decode) executes the per-token GEMM stream with M = m —
  continuous batching fuses prefill and decode tokens into one batched
  pass, which is exactly the decode-mode lowering of
  ``core.network`` with the batch replaced by the step composition.
- kv-cache traffic uses ``analysis.traffic``'s decode accounting: each
  decode request re-reads its full context
  (``kv_bytes_per_context_token`` x context length) and every new
  token writes one slot; SSM families pay the recurrent-state
  read+write per request (``state_bytes_per_request``). Attention
  score/value products are outside the weight-GEMM model (see
  ``core.network``), so the cache stream is charged as *serialized*
  memory time on the DRAM interface — the stand-in for the un-modeled
  attention kernel, and exactly zero under an unbounded
  ``BandwidthSpec`` (the compute-bound idealization).
- Energy charges each layer's active power over its compute cycles and
  the design's static power over every stalled or idle cycle
  (including arrival gaps), mirroring ``engine.evaluate``'s
  stall-aware energy; tokens/s/W therefore equals generated tokens per
  joule.

Feasibility (thermal + SRAM + the study's ``ConstraintSpec`` caps) is
evaluated on the chosen fixed design at the representative step, so
the usual masks strike serving points exactly like evaluate/pareto
points. Everything is deterministic given ``TrafficSpec.seed`` —
the trace sampler is one ``np.random.default_rng`` with a fixed draw
order — and the per-point state updates are elementwise, so chunking
the design grid (``--cache``/``--resume`` replays finished point
blocks) is bit-identical to one unchunked pass.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .analytical import FOLD_NAMES, native_fold
from .bandwidth import BandwidthSpec
from .cache import ResultCache
from .engine import DesignGrid, candidate_fixed_designs, evaluate
from .params import (
    VALID_LENGTH_DISTS,
    VALID_SERVE_MAPPINGS,
    VALID_SERVE_POLICIES,
    validate_option,
)
from .ppa import constants as C
from .ppa.power import array_power_batched
from .ppa.thermal import ThermalState, step_temps
from .pricing import (
    DvfsSpec,
    dram_bytes_per_cycle,
    governor_step,
    power_scales,
    price_steps,
)

__all__ = [
    "ServeSpec",
    "TrafficSpec",
    "restore_points",
    "run_serve",
    "sample_trace",
]

#: fields of the per-point payload arrays and their restored dtypes.
_POINT_INT = ("rows", "cols", "tiers", "steps", "tokens_prefilled",
              "tokens_decoded")
_POINT_BOOL = ("valid", "feasible", "feasible_steady")
_POINT_STR = ("dataflow", "tech")
_POINT_FLOAT = (
    "t_max_c", "area_um2", "gen_tok_s", "total_tok_s", "ttft_p50_s",
    "ttft_p99_s", "tpot_p50_s", "tpot_p99_s", "energy_j",
    "energy_per_token_j", "avg_power_w", "tokens_per_s_per_w",
    "makespan_s", "stall_frac", "dram_bytes",
    # transient-mode (thermal='transient') extras; absent on steady runs
    "peak_tok_s", "peak_vs_sustained", "t_max_transient_c",
)
POINT_FIELDS = _POINT_INT + _POINT_BOOL + _POINT_STR + _POINT_FLOAT


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """A seeded serving request stream (JSON-round-trippable).

    - ``arrival_rps``: request arrival rate [requests/s] — Poisson
      (exponential inter-arrival gaps).
    - ``n_requests``: trace length [requests].
    - ``prompt_dist``/``prompt_mean``/``prompt_max``: prompt length
      distribution ('fixed' | 'uniform' | 'lognormal'), its mean and
      the truncation bound [tokens]; sampled lengths land in
      ``[1, prompt_max]``. ``output_*``: same for generated lengths
      (the first token counts — a request produces ``output_len``
      tokens, the first at prefill completion).
    - ``sigma``: log-space spread of the lognormal distributions.
    - ``max_batch``: concurrent-request cap of the batching policy.
    - ``policy``: 'continuous' (admit into free slots every step) or
      'static' (drain each batch fully before admitting the next).
    - ``chunk_prefill``: prefill token budget per request per step
      (0 = whole prompt in one step) — chunked prefill interleaves
      long prompts with running decodes.
    - ``seed``: the one RNG seed behind arrivals and lengths.
    """

    arrival_rps: float = 256.0
    n_requests: int = 32
    prompt_dist: str = "lognormal"
    prompt_mean: int = 128
    prompt_max: int = 1024
    output_dist: str = "lognormal"
    output_mean: int = 32
    output_max: int = 256
    sigma: float = 0.6
    max_batch: int = 8
    policy: str = "continuous"
    chunk_prefill: int = 64
    seed: int = 0

    def __post_init__(self):
        validate_option("serve policy", self.policy, VALID_SERVE_POLICIES)
        for name in ("prompt_dist", "output_dist"):
            validate_option(name, getattr(self, name), VALID_LENGTH_DISTS)
        for name in ("arrival_rps", "sigma"):
            v = float(getattr(self, name))
            if not (math.isfinite(v) and v > 0):
                raise ValueError(f"{name} must be a positive finite rate, got {v}")
            object.__setattr__(self, name, v)
        for name in ("n_requests", "prompt_mean", "prompt_max", "output_mean",
                     "output_max", "max_batch"):
            v = int(getattr(self, name))
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
            object.__setattr__(self, name, v)
        for kind in ("prompt", "output"):
            mean, mx = getattr(self, f"{kind}_mean"), getattr(self, f"{kind}_max")
            if mean > mx:
                raise ValueError(
                    f"{kind}_mean {mean} exceeds the {kind}_max truncation "
                    f"bound {mx}"
                )
        v = int(self.chunk_prefill)
        if v < 0:
            raise ValueError(f"chunk_prefill must be >= 0 (0 = unchunked), got {v}")
        object.__setattr__(self, "chunk_prefill", v)
        object.__setattr__(self, "seed", int(self.seed))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrafficSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Simulator configuration for ``AnalysisSpec(kind='serve')``.

    The model-zoo workload and the design grid come from the study's
    ``WorkloadSpec`` (kind='network' required: arch + shape) and
    ``SpaceSpec``; this spec adds what serving needs on top:

    - ``traffic``: the ``TrafficSpec`` request stream.
    - ``bytes_kv``: kv-cache word size [bytes] (2 = bf16, matching
      ``analysis.traffic``'s decode accounting).
    - ``design_tokens``: the representative step token count the fixed
      (R, C) design search optimizes for (default:
      ``max_batch + chunk_prefill`` — the steady-state mixed step).
    - ``max_steps``: safety cap on simulation steps (default: derived
      from the trace; a bound no admissible schedule exceeds).
    - ``mapping``: ``'native'`` (default — each step priced at the
      dataflow's native tier mapping, bit-identical to studies written
      before the knob) or ``'tier_fold'`` — every step additionally
      prices the non-native tier folds (``analytical.fold_dims``) and
      takes, per layer and design point, the cheapest SRAM-feasible
      fold by total cycles, so serving rides the fine-grain tier-folded
      mapping exactly like ``engine.schedule``'s tier_fold policy.
    """

    traffic: TrafficSpec | dict = dataclasses.field(default_factory=TrafficSpec)
    bytes_kv: int = 2
    design_tokens: int | None = None
    max_steps: int | None = None
    mapping: str = "native"

    def __post_init__(self):
        if isinstance(self.traffic, dict):
            object.__setattr__(self, "traffic", TrafficSpec.from_dict(self.traffic))
        elif not isinstance(self.traffic, TrafficSpec):
            raise ValueError(
                f"traffic must be a TrafficSpec or dict, "
                f"got {type(self.traffic).__name__}"
            )
        v = int(self.bytes_kv)
        if v < 1:
            raise ValueError(f"bytes_kv must be >= 1 byte, got {v}")
        object.__setattr__(self, "bytes_kv", v)
        for name in ("design_tokens", "max_steps"):
            v = getattr(self, name)
            if v is not None:
                v = int(v)
                if v < 1:
                    raise ValueError(f"{name} must be >= 1, got {v}")
                object.__setattr__(self, name, v)
        validate_option("serve mapping", self.mapping, VALID_SERVE_MAPPINGS)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeSpec":
        return cls(**d)


# ---------------------------------------------------------------------------
# Traffic sampling
# ---------------------------------------------------------------------------

def sample_trace(spec: TrafficSpec) -> dict:
    """Sample the request trace (deterministic given ``spec.seed``).

    Returns ``arrival_s`` (float64 seconds, sorted), ``prompt_lens``
    and ``output_lens`` (int64 tokens, truncated to ``[1, *_max]``).
    The draw order (arrivals, then prompts, then outputs) is part of
    the determinism contract — same seed, bit-identical trace.
    """
    rng = np.random.default_rng(spec.seed)
    arrival_s = np.cumsum(rng.exponential(1.0 / spec.arrival_rps, spec.n_requests))

    def lengths(dist: str, mean: int, bound: int) -> np.ndarray:
        if dist == "fixed":
            v = np.full(spec.n_requests, float(mean))
        elif dist == "uniform":
            v = rng.uniform(1.0, 2.0 * mean - 1.0, spec.n_requests)
        else:  # lognormal with the requested mean
            mu = math.log(mean) - 0.5 * spec.sigma**2
            v = rng.lognormal(mu, spec.sigma, spec.n_requests)
        return np.clip(np.rint(v), 1, bound).astype(np.int64)

    return {
        "arrival_s": arrival_s,
        "prompt_lens": lengths(spec.prompt_dist, spec.prompt_mean, spec.prompt_max),
        "output_lens": lengths(spec.output_dist, spec.output_mean, spec.output_max),
    }


# ---------------------------------------------------------------------------
# Fixed-design derivation (per design point, schedule-style)
# ---------------------------------------------------------------------------

def _eval_kw(study, bandwidth) -> dict:
    kw = dict(
        backend=study.analysis.backend,
        metrics=("perf", "area", "power", "thermal"),
        thermal_limit=study.constraints.thermal_limit_c,
        shard=study.analysis.shard,
        bandwidth=bandwidth,
        device=study.analysis.device,
    )
    if study.analysis.chunk is not None:
        kw["chunk"] = study.analysis.chunk
    return kw


def _per_point(value, n: int) -> np.ndarray:
    """A grid's dataflow/tech attribute as a per-point str array."""
    return np.full(n, value) if isinstance(value, str) else np.asarray(value)


def _derive_designs(
    study, sub: DesignGrid, counts: np.ndarray, bandwidth,
    thermal: str = "steady",
) -> dict:
    """One fixed (R, C, L) array per design point of ``sub``.

    Mirrors ``engine.schedule``'s two passes, per point: the per-layer
    (R, C) optima at the representative step are the candidate set
    (``engine.candidate_fixed_designs``, the shared enumeration);
    candidates are re-evaluated explicitly over all layers and the
    count-weighted-cheapest wins — restricted to candidates feasible
    on every layer when ``constraints.require_feasible`` (falling back
    to the unrestricted optimum, flagged infeasible, when none is).

    ``thermal='transient'`` drops the worst-case steady thermal gate
    from the *selection* mask — the governed simulation decides thermal
    feasibility — while ``feasible_steady`` keeps the steady verdict
    for the peak-vs-sustained comparison.
    """
    kw = _eval_kw(study, bandwidth)
    res = evaluate(sub, **kw)
    Pb = sub.n_points
    df_p = _per_point(sub.dataflow, Pb)
    tech_p = _per_point(sub.tech, Pb)

    cand_rows, cand_cols, owner = candidate_fixed_designs(
        res, sub.tiers, per_point=True
    )
    cand = DesignGrid.explicit(
        sub.workloads,
        rows=cand_rows,
        cols=cand_cols,
        tiers=sub.tiers[owner],
        dataflow=sub.dataflow if isinstance(sub.dataflow, str) else df_p[owner],
        tech=sub.tech if isinstance(sub.tech, str) else tech_p[owner],
    )
    res_c = evaluate(cand, **kw)
    w = counts[:, None].astype(np.float64)
    tot = np.sum(w * res_c.cycles, axis=0)
    valid_c = res_c.valid.all(axis=0)
    feas_steady = study.constraints.mask(res_c).all(axis=0)
    if thermal == "transient" and res_c.within_thermal_budget is not None:
        relaxed = dataclasses.replace(
            res_c,
            within_thermal_budget=np.ones_like(res_c.within_thermal_budget),
        )
        feas_c = study.constraints.mask(relaxed).all(axis=0)
    else:
        feas_c = feas_steady

    pick = np.zeros(Pb, dtype=np.int64)
    for j in range(Pb):
        (idx,) = np.nonzero(owner == j)
        score = np.where(valid_c[idx], tot[idx], np.inf)
        if study.constraints.require_feasible and feas_c[idx].any():
            score = np.where(feas_c[idx], score, np.inf)
        pick[j] = idx[int(np.argmin(score))]

    t_max = (
        np.nanmax(np.where(np.isnan(res_c.t_max_c), -np.inf, res_c.t_max_c), axis=0)
        if res_c.t_max_c is not None
        else np.full(len(owner), np.nan)
    )
    return {
        "rows": cand_rows[pick],
        "cols": cand_cols[pick],
        "tiers": np.asarray(sub.tiers, dtype=np.int64),
        "dataflow": df_p,
        "tech": tech_p,
        "valid": valid_c[pick],
        "feasible": feas_c[pick],
        "feasible_steady": feas_steady[pick],
        "t_max_c": np.asarray(t_max, dtype=np.float64)[pick],
        "area_um2": np.asarray(res_c.area_um2[0], dtype=np.float64)[pick],
        "footprint_um2": np.asarray(
            res_c.footprint_um2[0], dtype=np.float64
        )[pick],
    }


# ---------------------------------------------------------------------------
# Step pricing: one vectorized engine call per simulation step
# ---------------------------------------------------------------------------

class _StepPricer:
    """Prices a (layers x design points) serving step in one batch.

    Precomputes the per-dataflow point groups and the per-point static
    power; ``price(m_tokens, kv_bytes)`` returns the step's total
    cycles, stall cycles, energy [J] and DRAM bytes per design point —
    ``max(compute, memory, vlink)`` per layer (Eqs. 1/2 +
    ``bandwidth.roofline_cycles``), count-weighted over the stream,
    plus the serialized kv-cache service time.

    ``mapping='tier_fold'`` additionally prices every non-native tier
    fold per step and keeps, per (layer, point), the cheapest
    SRAM-feasible fold by total cycles (ties keep the native mapping,
    so tier_fold is never slower than native).
    """

    def __init__(self, designs: dict, K, N, counts, bandwidth: BandwidthSpec,
                 mapping: str = "native"):
        self.rows = designs["rows"]
        self.cols = designs["cols"]
        self.tiers = designs["tiers"]
        self.tech = designs["tech"]
        self.valid = designs["valid"]
        self.K = np.asarray(K, dtype=np.int64)
        self.N = np.asarray(N, dtype=np.int64)
        self.counts = np.asarray(counts, dtype=np.float64)
        self.bw = bandwidth
        self.mapping = mapping
        df = designs["dataflow"]
        self.groups = {
            str(d): np.nonzero(df == d)[0] for d in np.unique(df).tolist()
        }
        self.static_w = np.zeros(self.rows.size)
        for d, idx in self.groups.items():
            pw = array_power_batched(
                1, 1, 1, self.rows[idx], self.cols[idx], self.tiers[idx],
                self.tech[idx], d,
            )
            self.static_w[idx] = pw["static_w"]

    def _price_group(self, d, m, Kc, Nc, R, Cc, L, tech, f, v):
        """One dataflow group's per-(layer, point) step pricing; under
        ``mapping='tier_fold'`` the elementwise cheapest SRAM-feasible
        fold (by total cycles, native winning ties) is returned."""
        pr = price_steps(d, m, Kc, Nc, R, Cc, L, tech, self.bw, f, v)
        if self.mapping != "tier_fold":
            return pr
        keys = ("total_cycles", "compute_cycles", "stall_cycles",
                "total_w", "dram_bytes")
        best = {k: pr[k] for k in keys}
        for fold in FOLD_NAMES:
            if fold == native_fold(d):
                continue
            p = price_steps(d, m, Kc, Nc, R, Cc, L, tech, self.bw, f, v,
                            fold=fold)
            better = (p["total_cycles"] < best["total_cycles"]) & (
                p["sram_need_bytes"] <= self.bw.sram_bytes
            )
            best = {k: np.where(better, p[k], best[k]) for k in keys}
        return best

    def price(self, m_tokens: np.ndarray, kv_bytes: np.ndarray,
              freq_hz=C.FREQ_HZ, vdd_v=C.VDD):
        """Step cycles (at ``freq_hz``), stall cycles, energy [J] and
        DRAM bytes per design point. ``freq_hz``/``vdd_v`` accept
        per-point arrays (the DVFS governor's operating points); the
        scalar default reproduces the 1 GHz pricing bit-for-bit."""
        P = self.rows.size
        step = np.zeros(P)
        stall = np.zeros(P)
        energy = np.zeros(P)
        dram = np.zeros(P)
        act = m_tokens > 0
        cw = self.counts[:, None]
        f_scalar = np.isscalar(freq_hz)
        v_scalar = np.isscalar(vdd_v)
        for d, idx in self.groups.items():
            if not act[idx].any():
                continue
            R, Cc, L = self.rows[idx], self.cols[idx], self.tiers[idx]
            m = np.maximum(m_tokens[idx], 1)  # priced, then masked by act
            Kc, Nc = self.K[:, None], self.N[:, None]
            f = freq_hz if f_scalar else freq_hz[idx]
            v = vdd_v if v_scalar else vdd_v[idx]
            pr = self._price_group(
                d, m[None, :], Kc, Nc, R[None, :], Cc[None, :], L[None, :],
                np.broadcast_to(
                    self.tech[idx][None, :], (self.K.size, idx.size)
                ),
                f, v,
            )
            compute = pr["compute_cycles"]
            w_total = np.sum(cw * pr["total_cycles"], axis=0)
            w_compute = np.sum(cw * compute, axis=0)
            kv_cyc = kv_bytes[idx] / dram_bytes_per_cycle(self.bw, f)
            _, ss = power_scales(f, v)
            step_g = w_total + kv_cyc
            e_active = np.sum(cw * pr["total_w"] * compute, axis=0) / f
            e_stall = self.static_w[idx] * ss * (step_g - w_compute) / f
            a = act[idx]
            step[idx] = np.where(a, step_g, 0.0)
            stall[idx] = np.where(
                a, np.sum(cw * pr["stall_cycles"], axis=0) + kv_cyc, 0.0
            )
            energy[idx] = np.where(a, e_active + e_stall, 0.0)
            dram[idx] = np.where(
                a,
                np.sum(cw * pr["dram_bytes"], axis=0) + kv_bytes[idx],
                0.0,
            )
        # structurally invalid designs serve nothing in finite time
        bad = act & ~self.valid
        step[bad] = np.inf
        stall[bad] = np.inf
        energy[bad] = np.inf
        return step, stall, energy, dram


# ---------------------------------------------------------------------------
# The queue simulator
# ---------------------------------------------------------------------------

def _simulate(designs: dict, K, N, counts, trace: dict, spec: ServeSpec,
              bandwidth: BandwidthSpec, cfg, thermal: str = "steady",
              dvfs: DvfsSpec | None = None,
              thermal_limit: float = C.THERMAL_BUDGET_C) -> dict:
    """Step the batched request queue on every design point at once.

    All per-point state is elementwise (a design point never reads
    another's state), so simulating a subset of points and slicing a
    full run give identical bits — the property the chunk cache and
    ``--resume`` rely on.

    ``thermal='transient'`` threads the DVFS governor through the
    stepping: every step is priced at the per-point governed (f, V)
    operating point, converted back to reference 1 GHz cycles for the
    queue clock, and the lumped RC stack integrates the step's average
    power over its wall-clock duration; the governor reacts to the
    hottest tier after every step. The output then *is* sustained
    serving performance, with ``t_max_transient_c`` (governed
    excursion) and ``dvfs_residency`` (per-state step fractions,
    (P, n_states)) added.
    """
    # deferred: analysis.traffic imports core.ppa, whose package
    # __init__ loads this module — importing at module scope would
    # cycle when repro.analysis is the entry point
    from ..analysis.traffic import (
        kv_bytes_per_context_token,
        state_bytes_per_request,
    )

    tr = spec.traffic
    pricer = _StepPricer(designs, K, N, counts, bandwidth,
                         mapping=spec.mapping)
    P, n = designs["rows"].size, tr.n_requests
    arrival = trace["arrival_s"] * C.FREQ_HZ  # cycles
    prompt = trace["prompt_lens"]
    output = trace["output_lens"]
    kv_tok = kv_bytes_per_context_token(cfg, spec.bytes_kv)
    ssm_req = state_bytes_per_request(cfg)
    chunk = tr.chunk_prefill if tr.chunk_prefill else int(prompt.max())

    state = np.zeros((P, n), dtype=np.int8)  # 0 wait, 1 prefill, 2 decode, 3 done
    rem_pf = np.broadcast_to(prompt, (P, n)).copy()
    rem_out = np.broadcast_to(output, (P, n)).copy()
    t = np.zeros(P)
    t_first = np.full((P, n), np.inf)
    t_done = np.full((P, n), np.inf)
    tok_pf = np.zeros(P, dtype=np.int64)
    tok_dec = np.zeros(P, dtype=np.int64)
    steps = np.zeros(P, dtype=np.int64)
    total_cyc = np.zeros(P)
    stall_cyc = np.zeros(P)
    energy = np.zeros(P)
    dram = np.zeros(P)

    governed = thermal == "transient"
    if governed:
        if dvfs is None:
            dvfs = DvfsSpec()
        freqs = dvfs.freqs_hz()
        vdds = np.asarray(dvfs.vdds_v, dtype=np.float64)
        _, ss_states = dvfs.scales()
        gstate = np.full(P, dvfs.n_states - 1, dtype=np.int64)
        tstate = ThermalState.init(
            designs["footprint_um2"] * 1e-6,
            designs["tiers"],
            designs["tech"],
            (designs["rows"] * designs["cols"]).astype(np.float64),
        )
        tiers_f = designs["tiers"].astype(np.float64)
        resid = np.zeros((P, dvfs.n_states))
        n_ran = np.zeros(P)
        t_hot = np.full(P, -np.inf)
        rows_p = np.arange(P)

    cap = spec.max_steps or int(
        n * (-(-int(prompt.max()) // chunk) + int(output.max()) + 2) + 16
    )
    it = 0
    while (state < 3).any():
        it += 1
        if it > cap:
            raise RuntimeError(
                f"serve simulation exceeded {cap} steps — raise "
                f"ServeSpec.max_steps or check the traffic spec"
            )
        waiting = state == 0
        active = (state == 1) | (state == 2)
        has_act = active.any(axis=1)
        # Idle points jump to their next arrival (static power still burns).
        next_arr = np.min(np.where(waiting, arrival[None, :], np.inf), axis=1)
        gap = np.where(~has_act & (next_arr > t), next_arr - t, 0.0)
        with np.errstate(invalid="ignore"):
            static_now = (
                pricer.static_w * ss_states[gstate] if governed
                else pricer.static_w
            )
            e_gap = np.where(gap > 0, static_now * gap / C.FREQ_HZ, 0.0)
            energy += e_gap
        t = t + gap
        # Admission, in arrival order, into the policy's free slots.
        slots = tr.max_batch - active.sum(axis=1)
        if tr.policy == "static":
            slots = np.where(has_act, 0, tr.max_batch)
        elig = waiting & (arrival[None, :] <= t[:, None])
        admit = elig & (np.cumsum(elig, axis=1) <= slots[:, None])
        state = np.where(admit, np.int8(1), state)
        # Step composition: chunked prefill + one token per decode.
        pf = state == 1
        dec = state == 2
        pf_tok = np.where(pf, np.minimum(rem_pf, chunk), 0)
        n_pf = pf_tok.sum(axis=1)
        n_dec = dec.sum(axis=1)
        m = n_pf + n_dec
        ctx = np.where(dec, prompt[None, :] + (output[None, :] - rem_out), 0)
        kv_bytes = (ctx.sum(axis=1) + n_dec + n_pf) * kv_tok + n_dec * ssm_req
        if governed:
            f_cur = freqs[gstate]
            step, stl, e, db = pricer.price(m, kv_bytes, f_cur, vdds[gstate])
            # queue time is kept in reference 1 GHz cycles: a step at a
            # throttled clock costs proportionally more of them.
            scale = C.FREQ_HZ / f_cur
            step = step * scale
            stl = stl * scale
        else:
            step, stl, e, db = pricer.price(m, kv_bytes)
        t_new = t + step
        ran = m > 0
        if governed:
            with np.errstate(invalid="ignore", divide="ignore"):
                dt_s = (gap + np.where(ran, step, 0.0)) / C.FREQ_HZ
                e_iter = e_gap + np.where(ran, e, 0.0)
                upd = (dt_s > 0) & np.isfinite(dt_s)
                dt_safe = np.where(upd, dt_s, 1.0)
                p_avg = np.where(
                    upd & np.isfinite(e_iter), e_iter / dt_safe, 0.0
                )
                q = np.where(
                    tstate.alive, (p_avg / tiers_f)[:, None], 0.0
                )
                t_next = step_temps(tstate, q, dt_safe).temps_c
                tstate = dataclasses.replace(
                    tstate,
                    temps_c=np.where(upd[:, None], t_next, tstate.temps_c),
                )
            t_hot = np.fmax(t_hot, tstate.t_max_c)
            resid[rows_p[ran], gstate[ran]] += 1.0
            n_ran += ran
            gstate = governor_step(gstate, tstate.t_max_c, thermal_limit, dvfs)
        steps += ran
        total_cyc += np.where(ran, step, 0.0)
        stall_cyc += np.where(ran, stl, 0.0)
        energy += np.where(ran, e, 0.0)
        dram += np.where(ran, db, 0.0)
        tok_pf += n_pf
        tok_dec += n_dec
        # Progress: prefill completions emit their first token this step.
        rem_pf = rem_pf - pf_tok
        done_pf = pf & (rem_pf == 0)
        t_first = np.where(done_pf, t_new[:, None], t_first)
        rem_out = rem_out - (done_pf | dec)
        tok_dec += done_pf.sum(axis=1)
        state = np.where(done_pf, np.int8(2), state)
        finished = (state == 2) & (rem_out == 0)
        t_done = np.where(finished, t_new[:, None], t_done)
        state = np.where(finished, np.int8(3), state)
        t = t_new

    with np.errstate(invalid="ignore", divide="ignore"):
        makespan = t_done.max(axis=1) / C.FREQ_HZ
        ttft = (t_first - arrival[None, :]) / C.FREQ_HZ
        tokens_out = int(output.sum())
        tokens_in = int(prompt.sum())
        multi = output > 1
        if multi.any():
            tpot = (t_done[:, multi] - t_first[:, multi]) / (
                (output[multi] - 1)[None, :] * C.FREQ_HZ
            )
            tpot_p50 = np.percentile(tpot, 50, axis=1)
            tpot_p99 = np.percentile(tpot, 99, axis=1)
        else:
            tpot_p50 = np.full(P, np.nan)
            tpot_p99 = np.full(P, np.nan)
        gen_tok_s = tokens_out / makespan
        avg_power = energy / makespan
        out = {
            "gen_tok_s": gen_tok_s,
            "total_tok_s": (tokens_in + tokens_out) / makespan,
            "ttft_p50_s": np.percentile(ttft, 50, axis=1),
            "ttft_p99_s": np.percentile(ttft, 99, axis=1),
            "tpot_p50_s": tpot_p50,
            "tpot_p99_s": tpot_p99,
            "energy_j": energy,
            "energy_per_token_j": energy / tokens_out,
            "avg_power_w": avg_power,
            "tokens_per_s_per_w": gen_tok_s / avg_power,
            "makespan_s": makespan,
            "steps": steps,
            "stall_frac": stall_cyc / total_cyc,
            "dram_bytes": dram,
            "tokens_prefilled": tok_pf,
            "tokens_decoded": tok_dec,
        }
        if governed:
            out["t_max_transient_c"] = np.where(
                designs["valid"], t_hot, np.nan
            )
            out["dvfs_residency"] = resid / np.maximum(n_ran, 1.0)[:, None]
    return out


# ---------------------------------------------------------------------------
# Payload assembly / restore
# ---------------------------------------------------------------------------

def restore_points(d: dict) -> dict:
    """JSON-decoded per-point dict -> typed numpy arrays (the serve
    payload's analogue of ``EvalResult.from_dict``)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, np.ndarray):
            out[k] = v
        elif k in _POINT_INT:
            out[k] = np.asarray(v, dtype=np.int64)
        elif k in _POINT_BOOL:
            out[k] = np.asarray(v, dtype=bool)
        elif k in _POINT_STR:
            out[k] = np.asarray(v)
        else:
            out[k] = np.asarray(v, dtype=np.float64)
    return out


def _summarize(points: dict, require_feasible: bool) -> dict:
    """Best-3D vs best-2D on tokens/s/W over the (feasible) points."""
    ok = points["feasible"] if require_feasible else points["valid"]
    is2d = (points["tiers"] == 1) | (points["tech"] == "2d")
    eff = np.where(ok, points["tokens_per_s_per_w"], -np.inf)

    def best(mask):
        e = np.where(mask, eff, -np.inf)
        if not np.isfinite(e.max()):
            return None
        i = int(np.argmax(e))
        return {
            "point": i,
            "design": [int(points["rows"][i]), int(points["cols"][i]),
                       int(points["tiers"][i])],
            "tech": str(points["tech"][i]),
            "tokens_per_s_per_w": float(points["tokens_per_s_per_w"][i]),
            "gen_tok_s": float(points["gen_tok_s"][i]),
            "ttft_p99_s": float(points["ttft_p99_s"][i]),
        }

    b3, b2 = best(~is2d), best(is2d)
    return {
        "n_feasible": int(points["feasible"].sum()),
        "best_3d": b3,
        "best_2d": b2,
        "win_3d_vs_2d": (
            b3["tokens_per_s_per_w"] / b2["tokens_per_s_per_w"]
            if b3 and b2 and b2["tokens_per_s_per_w"] > 0
            else None
        ),
    }


def run_serve(study, stream, cache: ResultCache | None = None) -> dict:
    """Execute a ``kind='serve'`` study; returns the payload dict.

    ``stream`` is the study's resolved workload (its arch/shape naming
    is the contract; serving re-lowers the network per step token).
    With a cache, consecutive design-point blocks are the chunk unit
    (``points-<lo>-<hi>``, like ``Study._evaluate``): each block
    derives its fixed designs and simulates independently, so
    ``--resume`` recomputes exactly the missing points and the stitched
    payload is bit-identical to an uncached run.
    """
    from .study import _jsonify  # deferred: study imports this module

    spec: ServeSpec = study.analysis.serve
    tr = spec.traffic
    if study.workload.kind != "network":
        raise ValueError(
            "kind='serve' needs a kind='network' workload (a model-zoo arch "
            "+ shape) — the traffic simulator prices that network's per-step "
            "GEMM stream"
        )
    from ..configs import REGISTRY, SHAPES

    from .network import lower_network

    cfg = REGISTRY[study.workload.arch]
    # Per-token GEMM structure: one decode step at batch 1 — M becomes
    # the step's token count, counts/K/N are the per-step stream.
    step_shape = dataclasses.replace(
        SHAPES[study.workload.shape], global_batch=1, mode="decode"
    )
    per_tok = lower_network(cfg, step_shape)
    K = per_tok.workloads[:, 1]
    N = per_tok.workloads[:, 2]
    counts = per_tok.counts

    bandwidth = study.analysis.bandwidth or BandwidthSpec()
    thermal = study.analysis.thermal
    dvfs = study.analysis.dvfs
    if thermal == "transient" and dvfs is None:
        dvfs = DvfsSpec()
    m_rep = spec.design_tokens or (tr.max_batch + tr.chunk_prefill)
    wl_rep = np.column_stack(
        [np.full(K.size, m_rep, dtype=np.int64), K, N]
    )
    grid = study.space.to_grid(wl_rep)
    trace = sample_trace(tr)
    P = grid.n_points

    block = P if cache is None else max(1, cache.block_cells // max(tr.n_requests, 1))
    parts = []
    for lo in range(0, P, max(block, 1)):
        hi = min(lo + block, P)
        key = f"points-{lo:010d}-{hi:010d}"
        d = cache.load_chunk(study, key) if cache is not None else None
        if d is None:
            sub = grid.subset(lo, hi)
            designs = _derive_designs(study, sub, counts, bandwidth, thermal)
            metrics = _simulate(designs, K, N, counts, trace, spec, bandwidth, cfg)
            d = {k: designs[k] for k in
                 ("rows", "cols", "tiers", "dataflow", "tech", "valid",
                  "feasible", "t_max_c", "area_um2")}
            if thermal == "transient":
                gov = _simulate(
                    designs, K, N, counts, trace, spec, bandwidth, cfg,
                    thermal="transient", dvfs=dvfs,
                    thermal_limit=study.constraints.thermal_limit_c,
                )
                d["feasible_steady"] = designs["feasible_steady"]
                d["peak_tok_s"] = metrics["gen_tok_s"]
                d.update(gov)
                with np.errstate(invalid="ignore", divide="ignore"):
                    d["peak_vs_sustained"] = (
                        d["peak_tok_s"] / gov["gen_tok_s"]
                    )
                # governed verdict replaces the worst-case steady gate
                d["feasible"] = (
                    designs["feasible"]
                    & np.isfinite(d["t_max_transient_c"])
                    & (d["t_max_transient_c"]
                       < study.constraints.thermal_limit_c)
                )
            else:
                d.update(metrics)
            if cache is not None:
                cache.store_chunk(study, key, _jsonify(d))
        parts.append(restore_points(d))
    points = {
        k: np.concatenate([p[k] for p in parts]) for k in parts[0]
    }
    extra = (
        {"thermal": "transient", "dvfs": dvfs.to_dict()}
        if thermal == "transient"
        else {}
    )
    return {
        "arch": study.workload.arch,
        "shape": study.workload.shape,
        **extra,
        "n_points": P,
        "n_gemm_layers": int(K.size),
        "design_tokens": int(m_rep),
        "trace": {
            "n_requests": tr.n_requests,
            "tokens_in": int(trace["prompt_lens"].sum()),
            "tokens_out": int(trace["output_lens"].sum()),
            "prompt_min": int(trace["prompt_lens"].min()),
            "prompt_max": int(trace["prompt_lens"].max()),
            "output_min": int(trace["output_lens"].min()),
            "output_max": int(trace["output_lens"].max()),
            "last_arrival_s": float(trace["arrival_s"][-1]),
        },
        "points": points,
        "summary": _summarize(points, study.constraints.require_feasible),
    }
