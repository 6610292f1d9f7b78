"""Core library: the paper's contribution.

- ``analytical``: Eqs. 1-2 runtime model + array-shape/tier optimizers.
- ``dataflow``: OS/WS/IS/dOS descriptors + switching activities.
- ``systolic``: cycle-level functional simulator (validates dOS).
- ``engine``: batched design-space evaluation engine (perf + PPA in one
  vectorized pass over whole workload x design grids).
- ``dse``: the paper's design-space sweeps (Figs. 5-7), thin wrappers
  over the engine.
- ``ppa``: power / area / thermal models (Table II, Figs. 8-9), with
  batched entry points the engine consumes.
- ``advisor``: the DSE generalized to TPU-mesh sharding choices, ranked
  through the engine.
- ``study``: the declarative front door — JSON-round-trippable
  ``Study`` specs compiled into the engine, returning versioned
  ``StudyResult`` artifacts (what ``python -m repro_torch`` drives),
  with ``network`` (zoo lowering), ``search``, ``serve`` (serving
  traffic) and ``cache`` (resumable chunks) behind it.
- ``calibrate``: times the port's kernels and fits the roofline model
  the engine prices designs with.
- ``params``: the shared option vocabularies + validators every API
  boundary uses.
"""

from . import (
    advisor, analytical, calibrate, dataflow, dse, engine, params, ppa, study, systolic,
)
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
from .advisor import GemmShard, choose_sharding, rank_candidates, score_strategies
from .dataflow import DOS, IS, OS, WS, activity_batched, dos_activity
from .engine import (
    DesignGrid,
    EvalResult,
    evaluate,
    optimal_tiers_batched,
    pareto_frontier,
)
from .study import (
    AnalysisSpec,
    ConstraintSpec,
    SpaceSpec,
    Study,
    StudyResult,
    WorkloadSpec,
)
from .systolic import simulate_dos_3d, simulate_os_2d

__all__ = [
    "advisor",
    "analytical",
    "calibrate",
    "dataflow",
    "dse",
    "engine",
    "params",
    "ppa",
    "study",
    "systolic",
    "AnalysisSpec",
    "ConstraintSpec",
    "SpaceSpec",
    "Study",
    "StudyResult",
    "WorkloadSpec",
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
    "GemmShard",
    "choose_sharding",
    "rank_candidates",
    "score_strategies",
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
