"""Design-space exploration sweeps (paper Figs. 5, 6, 7 and Sec. IV-A).

A numpy copy of the JAX package's ``core/dse.py``; every builder and
shim defaults to ``backend='torch'`` and also takes the Study's
``device`` (the torch backend's; ``None`` is the card).

These are the paper's workload/architecture studies, expressed as
declarative ``Study`` specs (``core.study``): each ``fig*_study``
builder returns the spec whose ``run()`` makes a **single** batched
engine call over every (workload, MAC budget, tier) combination — no
per-point Python loops. Regression tests pin the outputs bit-for-bit
to the original per-point loop implementations.

The classic call-style entry points (``fig5_sweep``/``fig6_sweep``/
``fig7_scatter``) remain as thin shims over the same specs: they run
the Study, reshape the payload into the historical return format, and
emit a ``DeprecationWarning`` pointing at the spec equivalent.

- Fig. 5: 3D-vs-2D speedup over tier count, for several MAC budgets and
  several K (M = 64, N = 147 fixed — ResNet50's RN0 M/N).
- Fig. 6: speedup over MAC budget at 4 tiers (M = 64), for several N and
  K; the threshold N_min = M*N below which 3D cannot win.
- Fig. 7: scatter of the *optimal* tier count for 300 random workloads
  drawn around ResNet50-like layer dimensions, for three MAC budgets;
  the optimal-tier distribution shifts right as the budget grows.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from .analytical import mac_threshold
from .study import AnalysisSpec, SpaceSpec, Study, WorkloadSpec

__all__ = [
    "fig5_study",
    "fig5_sweep",
    "fig6_study",
    "fig6_sweep",
    "fig7_study",
    "fig7_scatter",
    "random_workloads",
    "PAPER_WORKLOADS",
]

# Table I: exemplary layers from current DNN workloads mapped to M, K, N.
PAPER_WORKLOADS = {
    "RN0": (64, 12100, 147),  # ResNet50
    "RN1": (512, 784, 128),
    "GNMT0": (128, 4096, 2048),  # Google NMT
    "GNMT1": (320, 4096, 3072),
    "DB0": (1024, 50000, 16),  # DeepBench
    "DB1": (35, 2560, 4096),
    "TF0": (31999, 84, 1024),  # Transformer
    "TF1": (84, 4096, 1024),
}


def _deprecated(old: str, new: str):
    warnings.warn(
        f"{old} is deprecated; build the declarative equivalent with "
        f"{new} (core.study) and call .run() — same engine, same bits, "
        f"plus a serializable StudyResult artifact.",
        DeprecationWarning,
        stacklevel=3,
    )


def fig5_study(
    mac_budgets=(2**12, 2**14, 2**16, 2**18),
    ks=(255, 2560, 12100),
    tiers=tuple(range(1, 17)),
    M=64,
    N=147,
    mode="opt",
    backend="torch",
    device=None,
) -> Study:
    """The Fig.-5 sweep as a Study: speedup vs tier count for each
    (MAC budget, K); payload ``speedup`` is (K, budget, tier)."""
    return Study(
        name="fig5",
        workload=WorkloadSpec(kind="gemms", gemms=tuple((M, k, N) for k in ks)),
        space=SpaceSpec(mac_budgets=mac_budgets, tiers=tiers, mode=mode),
        analysis=AnalysisSpec(kind="sweep", figure="fig5", backend=backend,
                              device=device),
    )


def fig5_sweep(
    mac_budgets=(2**12, 2**14, 2**16, 2**18),
    ks=(255, 2560, 12100),
    tiers=tuple(range(1, 17)),
    M=64,
    N=147,
    mode="opt",
    backend="torch",
    device=None,
):
    """DEPRECATED shim over ``fig5_study``. Returns the historical
    ``(tiers, {(n_macs, K): [speedup per tier count]})`` format."""
    _deprecated("fig5_sweep(...)", "fig5_study(...)")
    res = fig5_study(mac_budgets, ks, tiers, M, N, mode, backend, device).run()
    s = np.asarray(res.payload["speedup"])
    out = {}
    for bi, n in enumerate(mac_budgets):
        for ki, k in enumerate(ks):
            out[(n, k)] = [float(v) for v in s[ki, bi]]
    return tiers, out


def fig6_study(
    mac_budgets=tuple(2**p for p in range(10, 19)),
    ns=(147, 1024),
    ks=(784, 4096),
    M=64,
    tiers=4,
    mode="opt",
    backend="torch",
    device=None,
) -> Study:
    """The Fig.-6 sweep as a Study: speedup vs MAC budget at a fixed
    tier count; payload ``speedup`` is (N x K, budget, 1), workload
    rows ordered N-major like the figure."""
    return Study(
        name="fig6",
        workload=WorkloadSpec(
            kind="gemms",
            gemms=tuple((M, k, n_dim) for n_dim in ns for k in ks),
        ),
        space=SpaceSpec(mac_budgets=mac_budgets, tiers=(tiers,), mode=mode),
        analysis=AnalysisSpec(kind="sweep", figure="fig6", backend=backend,
                              device=device),
    )


def fig6_sweep(
    mac_budgets=tuple(2**p for p in range(10, 19)),
    ns=(147, 1024),
    ks=(784, 4096),
    M=64,
    tiers=4,
    mode="opt",
    backend="torch",
    device=None,
):
    """DEPRECATED shim over ``fig6_study``. Returns the historical
    ``(mac_budgets, {(N, K): [speedup per budget]}, {N: N_min})``."""
    _deprecated("fig6_sweep(...)", "fig6_study(...)")
    res = fig6_study(mac_budgets, ns, ks, M, tiers, mode, backend, device).run()
    s = np.asarray(res.payload["speedup"]).reshape(len(ns), len(ks), len(mac_budgets))
    out = {}
    thresholds = {}
    for ni, n_dim in enumerate(ns):
        thresholds[n_dim] = mac_threshold(M, n_dim)
        for ki, k in enumerate(ks):
            out[(n_dim, k)] = [float(v) for v in s[ni, ki]]
    return mac_budgets, out, thresholds


@dataclasses.dataclass(frozen=True)
class Fig7Result:
    mac_budget: int
    optimal_tiers: np.ndarray  # per workload
    median: float


def random_workloads(n: int = 300, seed: int = 0):
    """Random workloads 'based on ResNet50 parameters' (Sec. IV-A.2):
    M, N sampled from conv-layer output/channel ranges, K from the
    unrolled reduction range of ResNet50 layers."""
    rng = np.random.default_rng(seed)
    M = rng.integers(16, 512, size=n)
    N = 2 ** rng.integers(4, 12, size=n)  # 16..2048 channels-ish
    K = rng.integers(64, 12100, size=n)
    return np.stack([M, K, N], axis=1)


def fig7_study(
    mac_budgets=(2**14, 2**16, 2**18),
    n_workloads=300,
    seed=0,
    max_tiers=16,
    mode="opt",
    backend="torch",
    device=None,
) -> Study:
    """The Fig.-7 scatter as a Study: optimal tier count per (random
    workload, budget); payload ``optimal_tiers`` is (workload, budget)."""
    return Study(
        name="fig7",
        workload=WorkloadSpec(kind="random", n=n_workloads, seed=seed),
        space=SpaceSpec(mac_budgets=mac_budgets,
                        tiers=tuple(range(1, max_tiers + 1)), mode=mode),
        analysis=AnalysisSpec(kind="sweep", figure="fig7", backend=backend,
                              device=device),
    )


def fig7_scatter(
    mac_budgets=(2**14, 2**16, 2**18),
    n_workloads=300,
    seed=0,
    max_tiers=16,
    mode="opt",
    backend="torch",
    device=None,
):
    """DEPRECATED shim over ``fig7_study``. Returns the historical
    ``[Fig7Result per budget]`` list."""
    _deprecated("fig7_scatter(...)", "fig7_study(...)")
    res = fig7_study(mac_budgets, n_workloads, seed, max_tiers, mode, backend,
                     device).run()
    best = np.asarray(res.payload["optimal_tiers"], dtype=np.int64)
    return [
        Fig7Result(
            mac_budget=b,
            optimal_tiers=best[:, bi],
            median=float(res.payload["medians"][bi]),
        )
        for bi, b in enumerate(mac_budgets)
    ]
