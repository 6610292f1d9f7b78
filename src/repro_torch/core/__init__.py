"""Core library: the paper's contribution.

- ``analytical``: Eqs. 1-2 runtime model + array-shape/tier optimizers.
- ``dataflow``: OS/WS/IS/dOS descriptors + switching activities.
- ``systolic``: cycle-level functional simulator (validates dOS).
- ``engine``: batched design-space evaluation engine (perf + PPA in one
  vectorized pass over whole workload x design grids).
- ``ppa``: power / area / thermal models (Table II, Figs. 8-9), with
  batched entry points the engine consumes.
- ``calibrate``: times the port's kernels and fits the roofline model
  the engine prices designs with.
- ``params``: the shared option vocabularies + validators every API
  boundary uses.

The JAX package's ``dse``, ``advisor`` and ``study`` front door are not
ported yet.
"""

from . import analytical, calibrate, dataflow, engine, params, ppa, systolic
from .analytical import (
    GEMM,
    ArrayPlan,
    mac_threshold,
    optimal_tiers,
    optimize_array_2d,
    optimize_array_3d,
    optimize_rc_batched,
    speedup_3d,
    tau_2d,
    tau_3d,
    tau_is,
    tau_ws,
)
from .dataflow import DOS, IS, OS, WS, activity_batched, dos_activity
from .engine import (
    DesignGrid,
    EvalResult,
    evaluate,
    optimal_tiers_batched,
    pareto_frontier,
)
from .systolic import simulate_dos_3d, simulate_os_2d

__all__ = [
    "analytical",
    "calibrate",
    "dataflow",
    "engine",
    "params",
    "ppa",
    "systolic",
    "GEMM",
    "ArrayPlan",
    "mac_threshold",
    "optimal_tiers",
    "optimize_array_2d",
    "optimize_array_3d",
    "optimize_rc_batched",
    "speedup_3d",
    "tau_2d",
    "tau_3d",
    "tau_is",
    "tau_ws",
    "DOS",
    "IS",
    "OS",
    "WS",
    "activity_batched",
    "dos_activity",
    "DesignGrid",
    "EvalResult",
    "evaluate",
    "optimal_tiers_batched",
    "pareto_frontier",
    "simulate_dos_3d",
    "simulate_os_2d",
]
