"""Frequency-aware step pricing + the DVFS governor.

One shared pricer for the ``dataflow_dims`` + ``gemm_traffic_batched``
+ ``roofline_cycles`` + power-charging sequence that ``core.engine``
and ``core.serve`` used to spell out independently. Everything here is
parameterized on an explicit clock ``freq_hz`` (and supply ``vdd_v``)
instead of baking in ``constants.FREQ_HZ`` — at the default
(1 GHz, VDD) every expression reduces to the exact op sequence the
call sites had before, so steady-state results stay bit-for-bit
identical (regression-pinned in ``tests/test_transient_thermal.py``).

Frequency/voltage conventions (standard CMOS first-order scaling,
relative to the reference operating point F0 = ``C.FREQ_HZ``,
V0 = ``C.VDD``):

- compute cycles and vertical-link cycles are clock-invariant counts;
- DRAM service is a wall-clock rate, so memory *cycles* scale with f
  (``dram_bytes_per_cycle`` = bytes/s / f);
- dynamic power scales with f * V^2, static (leakage + clock-tree
  bias) with V^2;
- seconds = cycles / f.

``DvfsSpec`` + ``governor_step`` + ``governed_run`` implement the
discrete-state governor: throttle one state down when the hottest tier
crosses ``limit - throttle_margin_c``, step back up only after it
cools below an additional ``hysteresis_c`` band. ``governed_run``
time-steps the lumped RC stack (``ppa.thermal.ThermalState``) over
repeated executions of a fixed work quantum and reports *sustained*
throughput next to the peak the steady-state model advertises.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .analytical import fold_dims
from .bandwidth import BandwidthSpec, fold_traffic_batched, roofline_cycles
from .ppa import constants as C
from .ppa.power import array_power_batched
from .ppa.thermal import ThermalState, step_temps

__all__ = [
    "DvfsSpec",
    "dram_bytes_per_cycle",
    "governed_run",
    "governor_step",
    "power_scales",
    "price_steps",
    "scale_power",
]


def dram_bytes_per_cycle(bandwidth: BandwidthSpec, freq_hz=C.FREQ_HZ):
    """DRAM service rate [bytes/cycle] at an explicit clock.

    Identical expression to ``BandwidthSpec.dram_bytes_per_cycle`` at
    the default clock (bit-for-bit), but a faster clock fits fewer
    bytes into each cycle — memory-bound regions do not speed up.
    """
    return bandwidth.dram_gbs * 1e9 / freq_hz


def power_scales(freq_hz=C.FREQ_HZ, vdd_v=C.VDD):
    """(dynamic, static) power multipliers vs the (F0, V0) reference.

    dynamic ∝ f * V^2, static ∝ V^2. Scalars in, scalars out; arrays
    broadcast.
    """
    return (
        (freq_hz / C.FREQ_HZ) * (vdd_v / C.VDD) ** 2,
        (vdd_v / C.VDD) ** 2,
    )


def scale_power(pw: dict, freq_hz=C.FREQ_HZ, vdd_v=C.VDD) -> dict:
    """Rescale an ``array_power_batched`` report to an operating point.

    At exactly the reference point the input dict is returned
    *unchanged* (same object) — the identity fast path that keeps the
    default-clock results bit-identical. Activity counts ("cycles" et
    al.) are clock-invariant and pass through untouched.
    """
    if (
        np.isscalar(freq_hz)
        and np.isscalar(vdd_v)
        and freq_hz == C.FREQ_HZ
        and vdd_v == C.VDD
    ):
        return pw
    sd, ss = power_scales(freq_hz, vdd_v)
    out = dict(pw)
    out["static_w"] = pw["static_w"] * ss
    out["dynamic_w"] = pw["dynamic_w"] * sd
    out["total_w"] = out["static_w"] + out["dynamic_w"]
    if "peak_w" in pw:
        # peak = total + headroom; the headroom is all-dynamic.
        out["peak_w"] = out["total_w"] + (pw["peak_w"] - pw["total_w"]) * sd
    return out


def price_steps(
    dataflow: str,
    M,
    K,
    N,
    rows,
    cols,
    tiers,
    tech,
    bandwidth: BandwidthSpec,
    freq_hz=C.FREQ_HZ,
    vdd_v=C.VDD,
    fold: str | None = None,
) -> dict:
    """Price one batch of GEMM steps on fixed arrays, in one call.

    The shared kernel behind ``engine.evaluate``'s explicit-design path
    and ``core.serve``'s queue stepping: dataflow fold geometry ->
    roofline'd cycles -> scaled power -> seconds / energy / per-tier
    watts. All array arguments broadcast together (the serve pricer
    passes (layers, points) matrices); ``dataflow``/``bandwidth``/
    ``fold`` and the operating point are uniform per call.

    ``fold`` selects a per-layer tier fold (``analytical.fold_dims``)
    for the ``tier_fold`` policy and the serve mapping knob; ``None``
    (or the dataflow's native fold) is the paper's tier split and
    reproduces the pre-fold pricing bit-for-bit.

    Returns a dict of broadcast arrays:
      ``compute_cycles``  array-busy cycles (clock-invariant count)
      ``mem_cycles``      DRAM service cycles at ``freq_hz``
      ``vlink_cycles``    serialized vertical-link cycles
      ``total_cycles``    rooflined max, ``stall_cycles`` its stall part
      ``dram_bytes``, ``vlink_bytes``, ``sram_need_bytes``  traffic
      ``total_w``/``static_w``/``dynamic_w``/``peak_w``  scaled power
      ``tier_w``          total_w / tiers (the thermal injection)
      ``seconds``         total_cycles / freq_hz
      ``energy_j``        active power over compute + static over stall
    """
    D1, D2, T = fold_dims(fold, dataflow, M, K, N, tiers)
    folds = -(-D1 // rows) * -(-D2 // cols)
    compute = (2 * rows + cols + T - 2).astype(np.float64) * folds
    tr = fold_traffic_batched(
        fold, dataflow, M, K, N, rows, cols, tiers, tech, bandwidth
    )
    bpc = dram_bytes_per_cycle(bandwidth, freq_hz)
    with np.errstate(invalid="ignore"):
        mem = tr["dram_bytes"] / bpc
    total, stall, bidx = roofline_cycles(compute, mem, tr["vlink_cycles"])
    pw = array_power_batched(M, K, N, rows, cols, tiers, tech, dataflow, fold=fold)
    pw = scale_power(pw, freq_hz, vdd_v)
    with np.errstate(invalid="ignore", divide="ignore"):
        seconds = total / freq_hz
        energy = (
            pw["total_w"] * compute + pw["static_w"] * stall
        ) / freq_hz
        tier_w = pw["total_w"] / tiers
    return {
        "compute_cycles": compute,
        "mem_cycles": mem,
        "vlink_cycles": tr["vlink_cycles"],
        "total_cycles": total,
        "stall_cycles": stall,
        "bound_idx": bidx,
        "dram_bytes": tr["dram_bytes"],
        "vlink_bytes": tr["vlink_bytes"],
        "sram_need_bytes": tr["sram_need_bytes"],
        "total_w": pw["total_w"],
        "static_w": pw["static_w"],
        "dynamic_w": pw["dynamic_w"],
        "peak_w": pw["peak_w"],
        "tier_w": tier_w,
        "seconds": seconds,
        "energy_j": energy,
    }


@dataclasses.dataclass(frozen=True)
class DvfsSpec:
    """Discrete DVFS operating states + governor policy (JSON-stable).

    States are listed slowest-first; the governor starts at (and cools
    back up toward) the top state. ``vdds_v`` defaults to a linear
    voltage ramp ending exactly at ``constants.VDD`` for the top state,
    so a top state at the reference 1 GHz reproduces the steady model's
    power bit-for-bit.

    ``throttle_margin_c`` backs the trip point off the thermal limit
    (trip at ``limit - margin``); ``hysteresis_c`` is the extra cooling
    band required before stepping back up — prevents limit cycling.
    ``sim_steps`` is the number of governed work quanta integrated by
    ``governed_run`` (sustained throughput is measured over the second
    half, after the thermal transient).
    """

    freqs_ghz: tuple = (0.5, 0.75, 1.0)
    vdds_v: tuple | None = None
    throttle_margin_c: float = 3.0
    hysteresis_c: float = 5.0
    sim_steps: int = 64

    def __post_init__(self):
        freqs = tuple(float(f) for f in self.freqs_ghz)
        if not freqs or any(f <= 0 for f in freqs):
            raise ValueError(
                f"freqs_ghz must be positive frequencies, got {freqs}"
            )
        if any(b <= a for a, b in zip(freqs, freqs[1:])):
            raise ValueError(
                f"freqs_ghz must be strictly ascending, got {freqs}"
            )
        object.__setattr__(self, "freqs_ghz", freqs)
        if self.vdds_v is None:
            top = freqs[-1]
            vdds = tuple(C.VDD * (0.6 + 0.4 * (f / top)) for f in freqs)
        else:
            vdds = tuple(float(v) for v in self.vdds_v)
            if len(vdds) != len(freqs):
                raise ValueError(
                    f"vdds_v must match freqs_ghz ({len(freqs)} states), "
                    f"got {len(vdds)}"
                )
            if any(v <= 0 for v in vdds):
                raise ValueError(f"vdds_v must be positive, got {vdds}")
            if any(b < a for a, b in zip(vdds, vdds[1:])):
                raise ValueError(
                    f"vdds_v must be non-decreasing, got {vdds}"
                )
        object.__setattr__(self, "vdds_v", vdds)
        for name in ("throttle_margin_c", "hysteresis_c"):
            v = float(getattr(self, name))
            if not np.isfinite(v) or v < 0:
                raise ValueError(f"{name} must be finite and >= 0, got {v}")
            object.__setattr__(self, name, v)
        steps = int(self.sim_steps)
        if steps < 2:
            raise ValueError(f"sim_steps must be >= 2, got {steps}")
        object.__setattr__(self, "sim_steps", steps)

    @property
    def n_states(self) -> int:
        return len(self.freqs_ghz)

    def freqs_hz(self) -> np.ndarray:
        return np.asarray(self.freqs_ghz, dtype=np.float64) * 1e9

    def scales(self) -> tuple:
        """Per-state (dynamic, static) power multipliers vs (F0, V0)."""
        return power_scales(
            self.freqs_hz(), np.asarray(self.vdds_v, dtype=np.float64)
        )

    def to_dict(self) -> dict:
        return {
            "freqs_ghz": list(self.freqs_ghz),
            "vdds_v": list(self.vdds_v),
            "throttle_margin_c": self.throttle_margin_c,
            "hysteresis_c": self.hysteresis_c,
            "sim_steps": self.sim_steps,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DvfsSpec":
        return cls(**d)


def governor_step(state_idx, t_max_c, limit_c: float, spec: DvfsSpec):
    """One governor decision per design: new state indices.

    Throttle down one state when the hottest tier is within
    ``throttle_margin_c`` of the limit; step up one state only after it
    cools a further ``hysteresis_c`` below the trip point. NaN
    temperatures (invalid designs) hold their state.
    """
    t = np.asarray(t_max_c, dtype=np.float64)
    trip = limit_c - spec.throttle_margin_c
    down = t >= trip
    up = t < (trip - spec.hysteresis_c)
    new = np.where(down, state_idx - 1, np.where(up, state_idx + 1, state_idx))
    return np.clip(new, 0, spec.n_states - 1)


def governed_run(
    compute_cycles,
    mem_cycles,
    vlink_cycles,
    static_w,
    dynamic_w,
    valid,
    tiers,
    tech,
    footprint_mm2,
    macs_per_tier,
    dvfs: DvfsSpec,
    limit_c: float,
    freq_hz: float = C.FREQ_HZ,
) -> dict:
    """DVFS-governed transient execution of one fixed work quantum.

    All per-design inputs are flat (B,) float64 arrays priced at the
    reference clock ``freq_hz``: the quantum's compute / memory /
    vertical-link cycles and its static / dynamic power draw. The run
    repeats the quantum ``dvfs.sim_steps`` times, at each step
    re-roofing the cycle count at the governed frequency (memory
    cycles scale with f, compute and vlink counts do not), stepping
    the lumped RC stack by the quantum's wall-clock duration, and
    letting the governor react to the hottest tier.

    Returns a dict of (B,) arrays (``residency`` is (B, n_states)):
      ``sustained_per_s``    quanta/s over the second half of the run
      ``peak_per_s``         quanta/s at the top state, cold
      ``peak_vs_sustained``  their ratio (>= 1 when throttling binds)
      ``t_max_transient_c``  hottest excursion over the whole run
      ``residency``          fraction of steps spent in each state
      ``within_limit``       governed excursion stayed under the limit
    """
    compute = np.asarray(compute_cycles, dtype=np.float64)
    mem = np.asarray(mem_cycles, dtype=np.float64)
    vlink = np.asarray(vlink_cycles, dtype=np.float64)
    B = compute.shape[0]
    S = dvfs.n_states
    freqs = dvfs.freqs_hz()
    sd, ss = dvfs.scales()

    state = np.full(B, S - 1, dtype=np.int64)
    tstate = ThermalState.init(footprint_mm2, tiers, tech, macs_per_tier)
    tiers_f = np.maximum(np.asarray(tiers, dtype=np.float64), 1.0)
    residency = np.zeros((B, S), dtype=np.float64)
    t_hot = np.full(B, -np.inf)
    rows_b = np.arange(B)
    half = dvfs.sim_steps // 2
    n_meas = dvfs.sim_steps - half
    time_meas = np.zeros(B, dtype=np.float64)

    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for k in range(dvfs.sim_steps):
            f = freqs[state]
            total = np.maximum(
                compute, np.maximum(mem * (f / freq_hz), vlink)
            )
            dt = np.where(valid, total / f, 1.0)
            p = static_w * ss[state] + dynamic_w * sd[state]
            q = np.where(
                tstate.alive,
                (np.where(valid, p, 0.0) / tiers_f)[:, None],
                0.0,
            )
            tstate = step_temps(tstate, q, dt)
            tmax = tstate.t_max_c
            t_hot = np.fmax(t_hot, tmax)
            residency[rows_b, state] += 1.0
            if k >= half:
                time_meas += np.where(valid, dt, 0.0)
            state = governor_step(state, tmax, limit_c, dvfs)

        sustained = np.where(
            valid & (time_meas > 0), n_meas / time_meas, np.nan
        )
        f_top = freqs[-1]
        total_top = np.maximum(
            compute, np.maximum(mem * (f_top / freq_hz), vlink)
        )
        peak = np.where(valid, f_top / total_top, np.nan)
        ratio = peak / sustained

    return {
        "sustained_per_s": sustained,
        "peak_per_s": peak,
        "peak_vs_sustained": ratio,
        "t_max_transient_c": np.where(valid, t_hot, np.nan),
        "residency": residency / dvfs.sim_steps,
        "within_limit": valid & (t_hot < limit_c),
    }
