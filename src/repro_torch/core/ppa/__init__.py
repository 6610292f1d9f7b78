"""Power / area / thermal models for 2D and 3D systolic arrays.

Every model has a batched entry point (``*_batched`` /
``lumped_tier_temps``) that evaluates whole design grids in one
vectorized pass — this is what ``core.engine`` calls — plus scalar
report wrappers for interactive use.
"""

from . import constants
from .area import (
    AreaReport,
    area_normalized_speedup,
    array_area_um2,
    array_area_um2_batched,
)
from .power import PowerReport, array_power, array_power_batched, table2_setup
from .thermal import ThermalReport, lumped_tier_temps, thermal_report

__all__ = [
    "constants",
    "AreaReport",
    "area_normalized_speedup",
    "array_area_um2",
    "array_area_um2_batched",
    "PowerReport",
    "array_power",
    "array_power_batched",
    "table2_setup",
    "ThermalReport",
    "lumped_tier_temps",
    "thermal_report",
]
