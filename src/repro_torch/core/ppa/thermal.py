"""Thermal model of 2D / 3D stacked arrays (paper Sec. IV-C).

Our HotSpot-6.0 analogue: the die stack is discretized into a
(tiers x g x g) grid of thermal cells. Steady state solves

    sum_j G_ij (T_j - T_i) + q_i = 0        for every cell i,

with lateral silicon conduction within a tier, vertical conduction
between tiers (ILD + TSV copper in parallel for the TSV flavour), and a
package/heatsink path from the *bottom* tier to ambient (the paper
splits results into "bottom" = near heatsink and "middle" = the rest).

The sparse system is solved with damped Jacobi iterations in torch, on
the card unless the caller names another device: a stencil relaxation
whose stop test is read back to the host once every
``_CHECK_EVERY`` iterations, not once per iteration. The power map
comes from the power model: cells inside the active M x N region carry
dynamic power, every cell carries clock+leakage; border cells end up
cooler purely through conduction, reproducing the paper's observed
in-die variability.

Reproduced qualitative findings (Fig. 8): 3D hotter than 2D; hotter
with more MACs; MIV hotter than TSV (TSVs add area -> lower power
density -> better heat spreading); all within the thermal budget.

Besides the steady state, the batched lumped model also exposes a
*transient* form (``ThermalState`` + ``step_temps``): each tier gets a
thermal mass (footprint x silicon thickness x volumetric heat capacity
of Si) and the same conductance stack is time-stepped with backward
Euler, so the steady-state solution is the exact fixed point under
constant power. This is what the DVFS governor integrates against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..._device import resolve_device
from ..params import VALID_TECHS, validate_option, validate_options
from .power import array_power
from . import constants as C

__all__ = [
    "ThermalReport",
    "ThermalState",
    "solve_stack",
    "step_temps",
    "thermal_report",
    "lumped_tier_temps",
]

_GRID = 24  # cells per die side


@dataclasses.dataclass(frozen=True)
class ThermalReport:
    tech: str
    macs_per_tier: int
    tiers: int
    t_max_c: float
    # five-number summaries (min, q1, median, q3, max) per region
    bottom: tuple
    middle: tuple | None
    within_budget: bool


_TOL = 1e-5  # stop after the first iteration whose max|dT| <= _TOL
_MAX_ITERS = 200_000
_CHECK_EVERY = 256  # iterations between two reads of the stop flag


def solve_stack(q_w, cell_area_mm2, tiers: int, tech: str, device=None):
    """Damped-Jacobi steady-state solve. q_w: (tiers, g, g) power map [W]
    (numpy or a tensor). ``device``: ``None`` means the card. Returns the
    (tiers, g, g) f32 temperature tensor on that device."""
    return _solve_stack(q_w, cell_area_mm2, tiers, tech, device)[0]


def _solve_stack(q_w, cell_area_mm2, tiers: int, tech: str, device=None):
    """``solve_stack`` that also returns its iteration count."""
    validate_option("tech", tech, VALID_TECHS)
    tiers = int(tiers)
    if tiers < 1:
        raise ValueError(f"tiers must be >= 1, got {tiers}")
    dev = resolve_device(device)
    # f32 on purpose: the reference model solves in f32 (its power map and
    # cell area enter its solve as f32), and the stop rule on max|dT| is
    # tuned to that precision. The reference's compiled solve also decides
    # how each value rounds: it folds the unit conversions into one
    # constant per conductance, adds the terms that do not depend on T
    # first, and contracts every product feeding a sum into one fused
    # multiply-add. The port forms each value the same way, the scalars
    # on the host in f32 and the fused products as ``add(x, y, alpha=a)``
    # (one rounding of x + a*y on both devices), so both give the same
    # bits and stop at the same iteration.
    f32 = np.float32
    q = torch.as_tensor(q_w, dtype=torch.float32).to(dev)
    g = q.shape[-1]
    area = f32(cell_area_mm2)

    t_si = (C.T_2D_SI_UM if tiers == 1 else C.T_TIER_SI_UM) * 1e-6
    # Lateral conductance between neighbouring cells (same tier).
    g_lat = float(f32(C.K_SI_W_MK * t_si))  # * (cell_side / cell_side)
    # Vertical conductance between stacked cells: ILD film + via metal
    # (K_ILD * cell area / ILD thickness; the 1e-6 of both cancel).
    g_vert = area * f32(C.K_ILD_W_MK / C.T_ILD_UM)
    if tech == "tsv":
        # TSV copper in parallel with the ILD. Per-cell via share
        # assumption: every thermal cell column carries the vertical
        # partial-sum bus of ~one MAC pile (VLINK_BITS vias), and a
        # quarter of each via's drawn area (A_TSV_UM2 includes the
        # keep-out zone) is conductive copper core. The lumped model
        # (lumped_tier_temps) charges the same share per MAC, so both
        # models see consistent vertical conductance densities.
        n_vias_cell = C.VLINK_BITS
        a_cu = n_vias_cell * (C.A_TSV_UM2 * 0.25) * 1e-12  # conductive core
        g_via = C.K_CU_W_MK * a_cu / (C.T_TIER_SI_UM * 1e-6)
        # one fused multiply-add: the f32 product is exact in f64
        g_vert = f32(np.float64(area) * np.float64(f32(C.K_ILD_W_MK / C.T_ILD_UM))
                     + np.float64(f32(g_via)))
    g_vert = float(g_vert)
    # Heatsink path from the bottom tier [W/K per cell], and its inflow
    # from ambient.
    g_sink = float(area * f32(1.0 / C.R_HEATSINK_KMM2_W))
    sink_in = float(area * f32(C.T_AMBIENT_C / C.R_HEATSINK_KMM2_W))
    # Lateral edge spreading into the package (per boundary cell).
    g_edge = float(np.sqrt(area) * f32(C.G_EDGE_PER_MM_W_K))
    edge = torch.zeros((g, g), dtype=torch.float32, device=dev)
    edge[0, :] = g_edge
    edge[-1, :] = g_edge
    edge[:, 0] = g_edge
    edge[:, -1] = g_edge
    edge = edge.expand(q.shape)

    # The weights w do not depend on T.
    w = edge.clone()
    w[:, 1:, :] += g_lat
    w[:, :-1, :] += g_lat
    w[:, :, 1:] += g_lat
    w[:, :, :-1] += g_lat
    if tiers > 1:
        w[1:] += g_vert
        w[:-1] += g_vert
    w[0] += g_sink
    s0 = torch.add(q, edge, alpha=C.T_AMBIENT_C)  # power plus edge inflow

    def neighbor_sum(T):
        s = s0.clone()
        # lateral (4-neighbourhood)
        s[:, 1:, :].add_(T[:, :-1, :], alpha=g_lat)
        s[:, :-1, :].add_(T[:, 1:, :], alpha=g_lat)
        s[:, :, 1:].add_(T[:, :, :-1], alpha=g_lat)
        s[:, :, :-1].add_(T[:, :, 1:], alpha=g_lat)
        if tiers > 1:
            # vertical between tiers (tier 0 = bottom, near heatsink)
            s[1:].add_(T[:-1], alpha=g_vert)
            s[:-1].add_(T[1:], alpha=g_vert)
        # heatsink from bottom tier
        s[0] += sink_in
        return s

    # The loop runs on the device without a host sync per iteration: an
    # iteration taken while ``active`` is False leaves T and the count as
    # they were, and ``active`` drops once an iteration's max|dT| is not
    # above _TOL (NaN included, as the reference's loop test reads it).
    # Reading ``active`` back every _CHECK_EVERY iterations, with the
    # last chunk cut at the cap, stops at the reference's iteration.
    T = torch.full_like(q, C.T_AMBIENT_C + 20.0)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    active = torch.ones((), dtype=torch.bool, device=dev)

    def step():  # one iteration, in place on T, it and active
        T_new = neighbor_sum(T) / w
        T_new = torch.add(T, T_new - T, alpha=0.9)  # light damping
        dT = torch.max(torch.abs(T_new - T))
        T.copy_(torch.where(active, T_new, T))
        it.add_(active)
        active.logical_and_(dT > _TOL)

    # On the card an iteration is ~20 tiny kernels whose launches the host
    # cannot keep up with: after the first chunk (run eagerly, on a side
    # stream, as graph capture wants) a whole chunk is replayed from one
    # CUDA graph. Same kernels, same bits.
    graph, n = None, 0
    while n < _MAX_ITERS:
        steps = min(_CHECK_EVERY, _MAX_ITERS - n)
        if graph is not None and steps == _CHECK_EVERY:
            graph.replay()
        elif dev.type == "cuda" and graph is None:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(steps):
                    step()
            torch.cuda.current_stream(dev).wait_stream(side)
        else:
            for _ in range(steps):
                step()
        n += steps
        if not bool(active):
            break
        if dev.type == "cuda" and graph is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(_CHECK_EVERY):
                    step()
    return T, int(it)


def lumped_tier_temps(q_tiers_w, footprint_mm2, tiers, tech, macs_per_tier):
    """Batched steady-state *lumped* tier temperatures (one node per tier).

    The engine's vectorized thermal path: where ``solve_stack`` resolves
    in-die gradients on a (tiers, g, g) grid for one design,
    this collapses each tier to a single thermal node and solves the
    whole batch of tier chains in one tridiagonal sweep — the same
    physics (vertical ILD+TSV conduction, bottom-tier heatsink, edge
    spreading scaling with perimeter) at die granularity.

    Args (broadcast over the batch dim B):
      q_tiers_w:     (B, Lmax) per-tier power [W]; entries beyond a
                     design's tier count are ignored.
      footprint_mm2: (B,) per-tier die footprint.
      tiers:         (B,) int tier counts (1..Lmax).
      tech:          (B,) str array ('2d'|'tsv'|'miv') — 'tsv' adds the
                     via copper to the vertical path.
      macs_per_tier: (B,) int — sizes the per-die TSV copper share.

    Returns (B, Lmax) float64 temperatures [C]; padded tiers read
    ambient. Tier 0 is the bottom (heatsink-side) tier.
    """
    q = np.asarray(q_tiers_w, dtype=np.float64)
    B, Lmax = q.shape
    footprint_mm2 = np.broadcast_to(np.asarray(footprint_mm2, np.float64), (B,))
    tiers = np.broadcast_to(np.asarray(tiers, np.int64), (B,))
    tech = np.broadcast_to(np.asarray(tech), (B,))
    macs_per_tier = np.broadcast_to(np.asarray(macs_per_tier, np.float64), (B,))
    diag, sub, sup, rhs, _ = _lumped_system(
        q, footprint_mm2, tiers, tech, macs_per_tier
    )
    return _thomas(diag, sub, sup, rhs)


def _lumped_system(q, footprint_mm2, tiers, tech, macs_per_tier):
    """Assemble the batched lumped tridiagonal system (already broadcast).

    Returns ``(diag, sub, sup, rhs, alive)`` with padded rows pinned to
    identity x ambient. ``rhs`` includes the per-tier power injection
    ``q``; pass zeros to get the q-independent part (the transient
    stepping adds its own source term per step).
    """
    validate_options("tech", tech, VALID_TECHS)
    if np.any(tiers < 1):
        raise ValueError(
            f"tiers must be >= 1 everywhere, got min {int(np.min(tiers))}"
        )
    Lmax = q.shape[1]
    a_m2 = footprint_mm2 * 1e-6
    g_ild = C.K_ILD_W_MK * a_m2 / (C.T_ILD_UM * 1e-6)
    # Per-MAC TSV copper share: each MAC pile carries VLINK_BITS vias,
    # of which a quarter of the drawn area (A_TSV_UM2 includes the
    # keep-out zone) is conductive core — the same per-cell share
    # solve_stack assumes, so grid and lumped vertical paths agree.
    a_cu = macs_per_tier * C.VLINK_BITS * (C.A_TSV_UM2 * 0.25) * 1e-12
    g_via = C.K_CU_W_MK * a_cu / (C.T_TIER_SI_UM * 1e-6)
    g_vert = np.where(tech == "tsv", g_ild + g_via, g_ild)
    g_sink = footprint_mm2 / C.R_HEATSINK_KMM2_W
    g_edge = C.G_EDGE_PER_MM_W_K * 4.0 * np.sqrt(footprint_mm2)

    idx = np.arange(Lmax)[None, :]
    alive = idx < tiers[:, None]
    has_below = alive & (idx > 0)
    has_above = idx < (tiers[:, None] - 1)

    # Tridiagonal system: diag * T_i - g_vert * (T_below + T_above) = rhs.
    diag = (
        g_edge[:, None] * alive
        + g_sink[:, None] * (idx == 0)
        + g_vert[:, None] * has_below
        + g_vert[:, None] * has_above
    )
    sub = np.where(has_below, -g_vert[:, None], 0.0)
    sup = np.where(has_above, -g_vert[:, None], 0.0)
    rhs = (
        np.where(alive, q, 0.0)
        + g_edge[:, None] * alive * C.T_AMBIENT_C
        + g_sink[:, None] * (idx == 0) * C.T_AMBIENT_C
    )
    # Padded nodes: identity rows pinned to ambient.
    diag = np.where(alive, diag, 1.0)
    rhs = np.where(alive, rhs, C.T_AMBIENT_C)
    return diag, sub, sup, rhs, alive


def _thomas(diag, sub, sup, rhs):
    """Vectorized Thomas algorithm over the batch (Lmax <= 16 is tiny).

    Degenerate rows (zero-area design points) divide 0/0 and yield
    NaN, which callers mask via their validity arrays.
    """
    Lmax = rhs.shape[1]
    with np.errstate(invalid="ignore", divide="ignore"):
        cp = np.zeros_like(rhs)
        dp = np.zeros_like(rhs)
        cp[:, 0] = sup[:, 0] / diag[:, 0]
        dp[:, 0] = rhs[:, 0] / diag[:, 0]
        for i in range(1, Lmax):
            denom = diag[:, i] - sub[:, i] * cp[:, i - 1]
            cp[:, i] = sup[:, i] / denom
            dp[:, i] = (rhs[:, i] - sub[:, i] * dp[:, i - 1]) / denom
        T = np.empty_like(rhs)
        T[:, -1] = dp[:, -1]
        for i in range(Lmax - 2, -1, -1):
            T[:, i] = dp[:, i] - cp[:, i] * T[:, i + 1]
    return T


@dataclasses.dataclass(frozen=True)
class ThermalState:
    """Batched transient state of the lumped tier stack.

    Holds the assembled (q-independent) conductance system plus each
    tier's heat capacity and current temperature; advance it with
    ``step_temps``. Build via ``ThermalState.init``.
    """

    temps_c: np.ndarray  # (B, Lmax) current tier temperatures [C]
    alive: np.ndarray  # (B, Lmax) bool, False on padded tiers
    diag: np.ndarray  # steady-state diagonal (padded rows = 1)
    sub: np.ndarray
    sup: np.ndarray
    rhs0: np.ndarray  # q-independent rhs (padded rows = ambient)
    cap_j_k: np.ndarray  # (B, Lmax) per-tier heat capacity [J/K], 0 padded

    @classmethod
    def init(
        cls,
        footprint_mm2,
        tiers,
        tech,
        macs_per_tier,
        t0_c: float = C.T_AMBIENT_C,
    ) -> "ThermalState":
        """Assemble a stack batch at a uniform start temperature.

        Args broadcast over the batch dim B exactly as in
        ``lumped_tier_temps``; the tier heat capacity is the silicon
        volume (footprint x tier thickness; full-thickness die for
        single-tier designs) times ``C_SI_J_M3K``.
        """
        tiers_b = np.atleast_1d(np.asarray(tiers, np.int64))
        B = tiers_b.shape[0]
        Lmax = int(np.max(tiers_b)) if B else 1
        footprint_mm2 = np.broadcast_to(
            np.asarray(footprint_mm2, np.float64), (B,)
        )
        tech_b = np.broadcast_to(np.asarray(tech), (B,))
        macs_b = np.broadcast_to(np.asarray(macs_per_tier, np.float64), (B,))
        q0 = np.zeros((B, Lmax), dtype=np.float64)
        diag, sub, sup, rhs0, alive = _lumped_system(
            q0, footprint_mm2, tiers_b, tech_b, macs_b
        )
        t_si_m = np.where(tiers_b == 1, C.T_2D_SI_UM, C.T_TIER_SI_UM) * 1e-6
        cap = footprint_mm2 * 1e-6 * t_si_m * C.C_SI_J_M3K  # J/K per tier
        cap_j_k = np.where(alive, cap[:, None], 0.0)
        temps = np.full((B, Lmax), float(t0_c), dtype=np.float64)
        return cls(
            temps_c=temps, alive=alive, diag=diag, sub=sub, sup=sup,
            rhs0=rhs0, cap_j_k=cap_j_k,
        )

    @property
    def t_max_c(self) -> np.ndarray:
        """(B,) hottest live tier per design."""
        return np.max(np.where(self.alive, self.temps_c, -np.inf), axis=1)


def step_temps(state: ThermalState, q_tiers_w, dt_s) -> ThermalState:
    """One backward-Euler step of the lumped stack: hold per-tier power
    ``q_tiers_w`` (B, Lmax) [W] for ``dt_s`` (scalar or (B,)) [s].

    Solves ``(C/dt + A) T' = (C/dt) T + rhs(q)`` with the same Thomas
    sweep as the steady solve, so it is unconditionally stable and the
    steady-state ``lumped_tier_temps`` solution is its exact fixed
    point under constant power. ``dt_s`` must be > 0 (use the caller's
    validity mask to skip degenerate points — NaN temperatures there
    are masked, exactly as in the steady path).
    """
    q = np.asarray(q_tiers_w, dtype=np.float64)
    dt = np.asarray(dt_s, dtype=np.float64)
    if dt.ndim == 1:
        dt = dt[:, None]
    with np.errstate(invalid="ignore", divide="ignore"):
        cdt = np.where(state.alive, state.cap_j_k / dt, 0.0)
        diag = state.diag + cdt
        rhs = state.rhs0 + np.where(
            state.alive, q + cdt * state.temps_c, 0.0
        )
        T = _thomas(diag, state.sub, state.sup, rhs)
    return dataclasses.replace(state, temps_c=T)


def _power_map(M, K, N, rows, cols, tiers, tech, g=_GRID):
    """Distribute the power report onto a (tiers, g, g) grid."""
    rep = array_power(M, K, N, rows, cols, tiers, tech)
    n_total = rows * cols * tiers
    base = rep.components["clk_leak_w"] + rep.components["die_wire_w"]
    dyn = rep.total_w - base
    q = np.full((tiers, g, g), base / (tiers * g * g), dtype=np.float64)
    # Active streaming region: rows x cols that actually carry operands.
    fr = min(M, rows) / rows
    fc = min(N, cols) / cols
    gr, gc = max(1, round(g * fr)), max(1, round(g * fc))
    q[:, :gr, :gc] += dyn / (tiers * gr * gc)
    return q, rep


def thermal_report(macs_per_tier: int, tiers: int, tech: str, M=128, K=300, N=128,
                   device=None):
    """Fig. 8 setup: per-layer temperature stats for a given config.
    The grid solve runs on ``device`` (``None``: the card)."""
    validate_option("tech", tech, VALID_TECHS)
    if int(tiers) < 1:
        raise ValueError(f"tiers must be >= 1, got {tiers}")
    side = int(np.sqrt(macs_per_tier))
    rows = cols = side
    q, rep = _power_map(M, K, N, rows, cols, tiers, tech)
    a_mac = C.A_MAC_UM2
    if tech == "tsv":
        a_mac = a_mac + C.VLINK_BITS * C.A_TSV_UM2 * (tiers - 1) / max(tiers, 1)
    elif tech == "miv":
        a_mac = a_mac + C.VLINK_BITS * C.A_MIV_UM2 * (tiers - 1) / max(tiers, 1)
    cell_area_mm2 = (macs_per_tier * a_mac * 1e-6) / (_GRID * _GRID)
    T = solve_stack(q, cell_area_mm2, tiers, tech, device).cpu().numpy()

    def stats(x):
        return tuple(float(v) for v in np.percentile(x, [0, 25, 50, 75, 100]))

    bottom = stats(T[0])
    middle = stats(T[1:]) if tiers > 1 else None
    t_max = float(T.max())
    return ThermalReport(
        tech=tech,
        macs_per_tier=macs_per_tier,
        tiers=tiers,
        t_max_c=t_max,
        bottom=bottom,
        middle=middle,
        within_budget=t_max < C.THERMAL_BUDGET_C,
    )
