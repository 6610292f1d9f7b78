"""Dynamic power model for 2D / 3D-TSV / 3D-MIV systolic arrays.

Reproduces the paper's Table II (Sec. IV-B). The paper's central
observation is that a *static* analysis is insufficient: the dOS
dataflow drives horizontal links hard while vertical (TSV/MIV) links
only carry partial-sum accumulation, so the two link classes have very
different switching activities. This model therefore builds power from
per-component switched energies x activity rates derived from the
dataflow (``core.dataflow.activity_batched``):

    P = P_clk+leak(n_macs)                 (clocked every cycle)
      + P_wire(n_macs, die_side)           (die-size-dependent overhead)
      + P_mac_dyn(useful MAC-op rate)
      + P_hlink(in-plane word-hop rate)
      + P_vlink(vertical net activity; C_TSV vs C_MIV)

Peak power adds the fully-active streaming path on top of the idle
baseline (paper reports PrimeTime peak).

``array_power_batched`` evaluates whole design grids at once (what the
engine calls); the scalar ``array_power`` wrapper is the batch-of-one
special case kept for interactive use and Table II.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..analytical import _ceil_div, native_fold
from ..dataflow import activity_batched
from . import constants as C

__all__ = ["PowerReport", "array_power", "array_power_batched", "table2_setup"]


@dataclasses.dataclass(frozen=True)
class PowerReport:
    tech: str  # '2d' | 'tsv' | 'miv'
    total_w: float
    peak_w: float
    components: dict
    runtime_cycles: float


def array_power_batched(M, K, N, rows, cols, tiers, tech, dataflow: str = "dos",
                        fold: str | None = None):
    """Batched power model: all arguments broadcast; ``tech`` is a str or
    array of '2d'|'tsv'|'miv'. Returns a dict of float64 arrays:

    ``total_w, peak_w, static_w, dynamic_w, clk_leak_w, die_wire_w,
    mac_dyn_w, hlink_w, vlink_w, cycles``.

    The in-plane hop count for OS/dOS charges the *full* array
    width/height (systolic shifting does not stop at the useful region)
    — the 2D array's hidden cost when R, C exceed the active M, N tile.
    WS/IS (no cross-tier traffic) are charged the operand-delivery hops
    from their activity model instead.

    ``fold`` (a non-native tier fold, see ``analytical.fold_dims``)
    reprices cycles and vertical activity through the folded activity
    model; non-native folds charge the generic operand-delivery hop
    model in-plane. ``None``/native is the existing model bit-for-bit.
    """
    M, K, N, R, Cc, L = np.broadcast_arrays(
        *(np.asarray(x, dtype=np.int64) for x in (M, K, N, rows, cols, tiers))
    )
    native = fold is None or fold == native_fold(dataflow)
    tech = np.broadcast_to(np.asarray(tech), M.shape)
    act = activity_batched(M, K, N, R, Cc, L, dataflow, fold=None if native else fold)
    n_per_tier = R * Cc
    n_total = n_per_tier * L
    t_s = act.cycles / C.FREQ_HZ

    # Baseline: clock tree + leakage on every MAC + die-size wiring term.
    # Active-wiring extent only: TSV keep-out zones enlarge the die but
    # carry no clocked wiring, so they do not add to the clock spine.
    side = np.sqrt(n_per_tier * C.A_MAC_UM2)
    p_base = n_total * (C.P_CLK_LEAK_PER_MAC_W + C.P_WIRE_PER_MAC_PER_UM_W * side)

    # Useful compute.
    p_mac = act.mac_ops_total * C.E_MAC_OP_J / t_s

    # In-plane streaming.
    if dataflow in ("os", "dos") and native:
        kl = _ceil_div(K, L)
        folds = _ceil_div(M, R) * _ceil_div(N, Cc)
        a_hops = np.minimum(M, R) * kl * Cc * folds * L
        b_hops = kl * np.minimum(N, Cc) * R * folds * L
        p_hop = (a_hops + b_hops) * C.E_HOP_J / t_s
    else:
        p_hop = act.hlink_hops_total * C.E_HOP_J / t_s

    # Vertical nets (3D only): bit-level activity x per-bit cap energy.
    cap = np.where(tech == "tsv", C.C_TSV_F, C.C_MIV_F)
    e_bit = 0.5 * cap * C.VDD**2
    n_vbits = n_per_tier * (L - 1) * C.VLINK_BITS
    p_v = np.where(
        (L > 1) & (tech != "2d") & (act.vlink_hops_total > 0),
        C.ALPHA_V * n_vbits * C.FREQ_HZ * e_bit,
        0.0,
    )

    total = p_base + p_mac + p_hop + p_v
    peak = total + n_total * C.E_MAC_PEAK_J * C.FREQ_HZ
    clk_leak = n_total * C.P_CLK_LEAK_PER_MAC_W
    return {
        "total_w": total,
        "peak_w": peak,
        "static_w": p_base,
        "dynamic_w": p_mac + p_hop + p_v,
        "clk_leak_w": clk_leak,
        "die_wire_w": p_base - clk_leak,
        "mac_dyn_w": p_mac,
        "hlink_w": p_hop,
        "vlink_w": p_v,
        "cycles": act.cycles,
    }


def array_power(
    M: int,
    K: int,
    N: int,
    rows: int,
    cols: int,
    tiers: int,
    tech: str,
) -> PowerReport:
    """Average + peak power of an array running the (M,K,N) GEMM.

    ``rows, cols`` are per-tier dimensions; ``tech`` selects the
    vertical-interconnect technology ('2d' forces tiers == 1). Scalar
    wrapper over ``array_power_batched`` (batch of one).
    """
    if tech == "2d":
        assert tiers == 1, "2D array cannot have tiers"
    r = array_power_batched(
        np.array([M]), np.array([K]), np.array([N]),
        np.array([rows]), np.array([cols]), np.array([tiers]), np.array([tech]),
    )
    return PowerReport(
        tech=tech,
        total_w=float(r["total_w"][0]),
        peak_w=float(r["peak_w"][0]),
        components={
            k: float(r[k][0])
            for k in ("clk_leak_w", "die_wire_w", "mac_dyn_w", "hlink_w", "vlink_w")
        },
        runtime_cycles=float(r["cycles"][0]),
    )


def table2_setup():
    """The paper's Table II configurations: workload M,N=128, K=300;
    3D = 3 tiers x 16384 MACs (128x128); 2D = 49284 MACs (222x222)."""
    return {
        "2d": dict(M=128, K=300, N=128, rows=222, cols=222, tiers=1, tech="2d"),
        "tsv": dict(M=128, K=300, N=128, rows=128, cols=128, tiers=3, tech="tsv"),
        "miv": dict(M=128, K=300, N=128, rows=128, cols=128, tiers=3, tech="miv"),
    }
