"""Area model and area-normalized performance (paper Sec. IV-D, Fig. 9).

2D: every MAC occupies A_MAC. 3D-TSV: each MAC additionally hosts a
dedicated vertical-link array (the paper deliberately over-provisions a
TSV array between every vertically adjacent MAC pair as a worst case);
TSVs carry a keep-out-zone, MIVs are ~3 orders of magnitude smaller
("monolithic integration only adds a few percent").

Fig. 9 plots runtime-per-total-silicon-area of the 3D array normalized
to the 2D array: ratio = speedup(l) / (1 + vlink_overhead(l)), where
the overhead scales with (l-1)/l (the bottom tier has no downward
links).

All entry points are batched (arrays broadcast); the scalar
``array_area_um2`` / ``area_normalized_speedup`` wrappers are the
batch-of-one special cases kept for interactive use.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..analytical import optimize_array_2d, optimize_array_3d
from . import constants as C

__all__ = [
    "AreaReport",
    "array_area_um2",
    "array_area_um2_batched",
    "area_normalized_speedup",
]


@dataclasses.dataclass(frozen=True)
class AreaReport:
    tech: str
    total_um2: float  # total silicon area (sum over tiers)
    footprint_um2: float  # per-tier footprint (the stacked outline)
    vlink_overhead: float  # vertical-link area / MAC area (per affected MAC)


def array_area_um2_batched(n_macs_total, tiers, tech):
    """Batched area model. ``tech`` is a str or array of '2d'|'tsv'|'miv'.

    Returns ``(total_um2, footprint_um2, vlink_overhead)`` float64
    arrays of the broadcast shape. Matches the scalar model exactly:
    the bottom tier carries no downward vias, so the per-MAC vertical
    overhead scales with (tiers-1)/tiers. '2d' entries add no via area
    but still split ``n_macs_total`` per tier when ``tiers`` > 1 (like
    the scalar model; query 2D dies with ``tiers == 1``).
    """
    n_macs_total, tiers = np.broadcast_arrays(
        *(np.asarray(x, dtype=np.int64) for x in (n_macs_total, tiers))
    )
    tech = np.broadcast_to(np.asarray(tech), n_macs_total.shape)
    per_tier = np.where(tiers > 1, n_macs_total // np.maximum(tiers, 1), n_macs_total)
    a_per_via = np.where(tech == "tsv", C.A_TSV_UM2, C.A_MIV_UM2)
    a_v = np.where(tech == "2d", 0.0, C.VLINK_BITS * a_per_via)
    frac = (tiers - 1) / np.maximum(tiers, 1)
    overhead = a_v * frac / C.A_MAC_UM2
    footprint = per_tier * (C.A_MAC_UM2 + a_v * frac)
    total = np.where(tech == "2d", footprint, footprint * tiers)
    return total, footprint, overhead


def array_area_um2(n_macs_total: int, tiers: int, tech: str) -> AreaReport:
    """Scalar wrapper over ``array_area_um2_batched`` (batch of one)."""
    total, footprint, overhead = array_area_um2_batched(
        np.array([n_macs_total]), np.array([tiers]), np.array([tech])
    )
    return AreaReport(tech, float(total[0]), float(footprint[0]), float(overhead[0]))


def area_normalized_speedup(M, K, N, n_macs, tiers, tech, mode="opt") -> float:
    """Fig. 9's y-axis: (perf/area of 3D) / (perf/area of 2D).

    Both chips are charged their full *provisioned* silicon area (the
    manufactured array), even when the optimizer maps the workload onto
    a sub-array — matching the paper's fixed-MAC-budget comparison.
    """
    t2 = optimize_array_2d(M, K, N, n_macs, mode)
    t3 = optimize_array_3d(M, K, N, n_macs, tiers, mode)
    a2 = array_area_um2(int(n_macs), 1, "2d").total_um2
    a3 = array_area_um2((int(n_macs) // tiers) * tiers, tiers, tech).total_um2
    return float((t2.cycles / t3.cycles) * (a2 / a3))
