"""Physical constants for the PPA models (15 nm nangate node, 1 GHz).

Literature-sourced constants come straight from the paper's references:
TSV capacitance ~10 fF [20], MIV capacitance ~0.2 fF [21]. The remaining
constants are *calibrated* so the structural power/area/thermal models
reproduce the paper's reported numbers (Table II watts, Fig. 9
crossovers, Fig. 8 trends); every calibrated value is annotated with its
target and stays within physically plausible ranges for a 15 nm node.

Calibration procedure (reproducible): solve the linear system formed by
Table II's three average-power rows for (P_CLK_LEAK_PER_MAC,
P_WIRE_PER_MAC_UM, ALPHA_V) given first-principles dynamic terms; then
fit E_MAC_PEAK to the three peak-power rows. See
``benchmarks/tab2_power.py`` for the closed loop.
"""

from __future__ import annotations

# --- Technology / operating point -----------------------------------------
VDD = 0.8  # V
FREQ_HZ = 1.0e9  # paper: 1 GHz clock
THERMAL_BUDGET_C = 105.0  # junction limit used for "not thermally limited"

# --- Vertical interconnect (paper-sourced) ---------------------------------
C_TSV_F = 10e-15  # [20] ~10 fF per TSV
C_MIV_F = 0.2e-15  # [21] ~0.2 fF per MIV
VLINK_BITS = 17  # 16b partial-sum bus + accumulate-control per MAC pile

# --- Area (calibrated to Fig. 9 bands; plausible 15 nm values) -------------
A_MAC_UM2 = 400.0  # 8b x 8b MAC + 16b acc + pipeline regs
A_TSV_UM2 = 30.0  # TSV + keep-out-zone, per via ([20]-scale)
A_MIV_UM2 = 0.05  # per MIV ([22]-scale); "few percent overhead"

# --- Power (calibrated to Table II; see module docstring) -------------------
# Per-MAC clock-tree + leakage power. 81 uW/MAC ~ a few dozen FFs at 1 GHz.
P_CLK_LEAK_PER_MAC_W = 8.088264759124456e-05
# Die-size-dependent wiring overhead (clock spine / distribution): grows
# with die side. This is the term that makes the monolithic-footprint 2D
# die (4.44 mm side) burn more than a 2.56 mm 3D tier - the physical
# mechanism behind Table II's "3D draws slightly less".
P_WIRE_PER_MAC_PER_UM_W = 9.256300411858144e-09
# Average dynamic energy per useful MAC-op (operand regs included).
E_MAC_OP_J = 100e-15
# Energy per word-hop on an in-plane neighbour link (wire + register).
E_HOP_J = 5e-15
# Vertical-net switching activity (bit-level, per cycle). Calibrated to
# the TSV-MIV split of Table II. NOTE: ~40x larger than the idealized
# dOS accumulate-only activity (1/tau_fold); the paper's RTL evidently
# toggles vertical nets beyond the minimal dataflow requirement,
# consistent with its stated worst-case TSV over-provisioning.
ALPHA_V = 0.07441636322497748
# Peak (single-cycle) dynamic energy per MAC when the streaming path is
# fully active; fits Table II's peak rows within ~2%.
E_MAC_PEAK_J = 165e-15

# --- Thermal (calibrated to Fig. 8 trends) ----------------------------------
K_SI_W_MK = 130.0  # silicon lateral conductivity
T_TIER_SI_UM = 20.0  # thinned tier silicon thickness (3D)
T_2D_SI_UM = 300.0  # full-thickness 2D die
T_ILD_UM = 1.0  # inter-tier dielectric thickness
K_ILD_W_MK = 1.4  # SiO2-ish
K_CU_W_MK = 400.0  # copper (TSV fill)
# Heatsink: package + spreader resistance from the die face to ambient,
# normalized per mm^2 of die area.
R_HEATSINK_KMM2_W = 40.0
T_AMBIENT_C = 45.0  # in-server ambient at the package
# Volumetric heat capacity of silicon — gives each tier a thermal mass
# (footprint x silicon thickness) for the transient RC stepping.
C_SI_J_M3K = 1.63e6  # J/(m^3 K)
# Lateral spreading from die edges into the package substrate. Smaller
# dies have a higher perimeter/area ratio, so they shed relatively more
# heat sideways — this produces the paper's "hotter with more MACs"
# trend (Fig. 8).
G_EDGE_PER_MM_W_K = 0.02

# --- Roofline hardware model (TPU v5e target) --------------------------------
TPU_PEAK_FLOPS_BF16 = 197e12  # per chip
TPU_HBM_BW = 819e9  # bytes/s per chip
TPU_ICI_BW_PER_LINK = 50e9  # bytes/s per link
