"""Shared option validation for the DSE stack.

Every layer of the stack — ``DesignGrid``, ``evaluate``, ``schedule``,
the declarative ``study`` specs and the CLI — accepts the same small
string vocabularies (dataflow, vertical-interconnect tech, metric
groups, search backends, shape-search modes). Before this module each
consumer either re-validated its own subset or let an invalid string
die deep in the PPA tables with a bare ``KeyError``/silent miv
fallback. This is the one place those vocabularies live; everything
else calls ``validate_option``/``validate_options`` at its API
boundary and fails fast with the full list of valid choices.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "VALID_BACKENDS",
    "VALID_DATAFLOWS",
    "VALID_FOLDS",
    "VALID_LENGTH_DISTS",
    "VALID_METRICS",
    "VALID_MODES",
    "VALID_OBJECTIVES",
    "VALID_SCHEDULE_POLICIES",
    "VALID_SERVE_MAPPINGS",
    "VALID_SERVE_POLICIES",
    "VALID_TECHS",
    "VALID_THERMAL_MODES",
    "validate_option",
    "validate_options",
]

#: 'os' is dOS at the l = 1 formulaic limit (see DesignGrid docs).
VALID_DATAFLOWS = ("os", "dos", "ws", "is")
#: vertical-interconnect technology ('2d' = no stacking).
VALID_TECHS = ("2d", "tsv", "miv")
#: result groups of ``engine.evaluate`` (thermal implies power implies
#: area — the implication is applied by ``evaluate``, not here).
VALID_METRICS = ("perf", "area", "power", "thermal")
#: search backends of the batched (R, C) kernel.
VALID_BACKENDS = ("numpy", "torch")
#: shape-search modes: full rectangular search vs square arrays.
VALID_MODES = ("opt", "square")
#: thermal analysis modes: 'steady' gates on the worst-case lumped
#: steady state at a fixed clock; 'transient' time-steps the same RC
#: stack under a DVFS governor and gates on the governed excursion.
VALID_THERMAL_MODES = ("steady", "transient")
#: per-layer tier folds: which GEMM dimension a stack of L tiers
#: partitions. Every dataflow has a *native* fold (its paper tier
#: split: 'k' for os/dos, 'm' for ws, 'n' for is) plus two non-native
#: folds priced by ``bandwidth.fold_traffic_batched``.
VALID_FOLDS = ("m", "k", "n")
#: scheduling policies of ``engine.schedule``: 'per_layer' re-shapes
#: the array per layer, 'fixed' commits one array for the stream,
#: 'tier_fold' commits one array but picks the best per-layer tier
#: fold (m/k/n) on it.
VALID_SCHEDULE_POLICIES = ("per_layer", "fixed", "tier_fold")
#: serving step-mapping: 'native' prices each step under the
#: dataflow's paper tier split; 'tier_fold' prices all folds and takes
#: the per-step elementwise best.
VALID_SERVE_MAPPINGS = ("native", "tier_fold")
#: serving batch policies (``core.serve.TrafficSpec``): 'continuous'
#: admits into free slots every step, 'static' drains each batch fully
#: before admitting the next.
VALID_SERVE_POLICIES = ("continuous", "static")
#: request length distributions of the serving traffic sampler.
VALID_LENGTH_DISTS = ("fixed", "uniform", "lognormal")
#: minimizable ``EvalResult`` metric columns (Pareto objectives).
#: ``stall_cycles`` is populated only by bandwidth-aware runs.
VALID_OBJECTIVES = (
    "cycles",
    "cycles_2d",
    "utilization",
    "mac_act",
    "hlink_act",
    "vlink_act",
    "area_um2",
    "footprint_um2",
    "power_w",
    "peak_power_w",
    "static_power_w",
    "dynamic_power_w",
    "energy_j",
    "edp_js",
    "t_max_c",
    "stall_cycles",
)


def validate_option(name: str, value, valid) -> str:
    """Check one scalar option; raise ValueError listing valid choices."""
    if isinstance(value, np.str_):
        value = str(value)
    if not isinstance(value, str) or value not in valid:
        raise ValueError(
            f"invalid {name} {value!r}; valid options: "
            + ", ".join(repr(v) for v in valid)
        )
    return value


def validate_options(name: str, value, valid):
    """Check a scalar-or-array option (e.g. a per-point ``tech`` array).

    Returns ``value`` unchanged so call sites can validate inline.
    """
    if isinstance(value, (str, np.str_)):
        validate_option(name, value, valid)
        return value
    arr = np.asarray(value)
    for v in np.unique(arr):
        validate_option(name, v, valid)
    return value
