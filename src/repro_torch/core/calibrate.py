"""Calibration harness: fit the roofline model to measured kernels.

The analytical model (``core.bandwidth``, ``analysis.roofline``) prices
every Study with *assumed* peak rates; the repo also ships real
``dos_matmul`` / ``flash_attention`` / ``ssm_scan`` kernels that are
never measured against it. This module closes that loop, the
measured-vs-modeled methodology of the fine-grain 3D-stack
characterization literature (arxiv 2409.10539):

1. **Sweep** the three kernel families over a shape grid
   (``shape_grid``): GEMM M/K/N including skewed tall/wide shapes,
   attention B/S/H/D in prefill (causal, GQA) and decode (KV-cache)
   modes, and SSM B/S/H/P/N chunked scans.
2. **Measure** each shape (``measure_row``): inputs are seeded (numpy,
   the same draws as the JAX package), the wrapper is built once per
   family (``_kernel_fn`` — a cached factory over the port's kernel
   wrappers), one untimed call builds and loads the family's kernel on
   its first use, then each call is timed on the host clock up to a
   ``torch.cuda.synchronize()``, median-of-reps after explicit warmup.
   The host clock includes each call's launch cost, which the fitted
   per-family overhead absorbs. Each row reports achieved FLOP/s and
   GB/s.
3. **Fit** (``fit_rows``): alternating least squares against
   ``analysis.roofline.roofline_terms_batched`` — every row is
   assigned to its binding term (compute vs memory) under the current
   parameters, then each parameter is re-fit in closed form from its
   assigned rows (relative-error-weighted LSQ), iterated to a fixed
   point. Fitted parameters: one effective compute rate per family
   (reported as an efficiency factor vs the nominal peak — the GEMM
   family's factor calibrates the GEMM dataflows dos/ws/is directly),
   one DRAM bandwidth (a ``BandwidthSpec.dram_gbs``), and a
   per-family launch overhead riding the combiner's additive
   ``collective_s`` slot (without it, every small shape reads as an
   impossibly slow rate).
4. **Report** model-vs-measured relative error per shape bucket, on
   the fit rows and on held-out rows (every ``holdout_every``-th shape
   never enters the fit), next to the error of the *uncalibrated*
   nominal constants — the gap is the point of calibrating.

The result is a ``CalibratedBandwidth`` artifact: a fitted
``BandwidthSpec`` plus per-family efficiency factors and fit
diagnostics. It is JSON-round-trippable and loadable back into any
Study via ``AnalysisSpec(bandwidth=...)`` (the spec layer unwraps it
to its embedded ``BandwidthSpec``, so a re-loaded artifact reproduces
bit-identical results).

Wall-clock numbers here are *backend* numbers (the card by default,
the CPU's plain versions where a caller asks for ``device='cpu'``) —
the harness calibrates whatever backend it runs on, which is exactly
what makes the model defensible there. The nominal peak rates of the
uncalibrated model (``ppa.constants.TPU_PEAK_FLOPS_BF16``,
``TPU_HBM_BW``) are constants of the model, kept so the fit and its
artifact stay those of the JAX package; they are not the card's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.ssm_scan.ops import CHUNK as _SSM_CHUNK
from .bandwidth import BandwidthSpec
from .params import validate_option
from .ppa import constants as HW

__all__ = [
    "CALIBRATE_FAMILIES",
    "CALIBRATE_PRESETS",
    "CalibrateSpec",
    "CalibratedBandwidth",
    "fit_rows",
    "measure_row",
    "run_calibration",
    "shape_grid",
]

CALIBRATE_FAMILIES = ("gemm", "attention", "ssm")
CALIBRATE_PRESETS = ("smoke", "default", "full")

#: ``_SSM_CHUNK`` is the port's scan chunk (``kernels.ssm_scan.ops.CHUNK``,
#: on every device); the analytic FLOP count of a chunked scan depends on it.

_F32 = 4  # bytes per f32 word (attention/SSM operand dtype)
_BF16 = 2  # bytes per bf16 word (GEMM operand dtype)


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CalibrateSpec:
    """What to calibrate and how carefully.

    - ``families``: kernel families to sweep (subset of
      ``CALIBRATE_FAMILIES``).
    - ``preset``: shape-grid size — ``'smoke'`` (a few small shapes,
      CI-sized), ``'default'`` (the calibration grid), ``'full'``
      (adds large shapes; minutes on CPU).
    - ``reps`` / ``warmup``: timed repetitions (median is reported)
      after untimed warmup calls.
    - ``holdout_every``: every N-th shape is excluded from the fit and
      used only to score generalization (0 disables holdout).
    - ``seed``: input-data seed (timings are data-independent for
      these kernels; the seed keeps rows reproducible anyway).
    """

    families: tuple[str, ...] = CALIBRATE_FAMILIES
    preset: str = "default"
    reps: int = 5
    warmup: int = 2
    holdout_every: int = 4
    seed: int = 0

    def __post_init__(self):
        fams = self.families
        if isinstance(fams, str):
            fams = (fams,)
        fams = tuple(str(f) for f in fams)
        for f in fams:
            validate_option("calibrate family", f, CALIBRATE_FAMILIES)
        if not fams:
            raise ValueError("families must name at least one kernel family")
        object.__setattr__(self, "families", fams)
        validate_option("calibrate preset", self.preset, CALIBRATE_PRESETS)
        for name, lo in (("reps", 1), ("warmup", 0), ("holdout_every", 0),
                         ("seed", 0)):
            v = int(getattr(self, name))
            if v < lo:
                raise ValueError(f"{name} must be >= {lo}, got {v}")
            object.__setattr__(self, name, v)
        if self.holdout_every == 1:
            raise ValueError(
                "holdout_every=1 would hold out every shape; use 0 to "
                "disable holdout or >= 2 to keep fit rows"
            )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrateSpec":
        return cls(**d)


# ---------------------------------------------------------------------------
# Shape grids
# ---------------------------------------------------------------------------

def _gemm_shapes(preset: str):
    smoke = [(256, 256, 256), (128, 1024, 256)]
    default = smoke + [
        (512, 512, 512),
        (512, 2048, 512),
        (1024, 1024, 256),
        (2048, 512, 128),   # tall
        (128, 512, 2048),   # wide
        # thin: low arithmetic intensity (memory-assigned). True
        # matvecs (m=1) are deliberately absent: a bf16 GEMV on CPU
        # times dtype conversion, not bandwidth, and poisons the fit.
        (16, 2048, 2048),
        (16, 4096, 1024),
    ]
    full = default + [(1024, 1024, 1024), (4096, 1024, 128), (16, 8192, 2048)]
    return {"smoke": smoke, "default": default, "full": full}[preset]


def _attention_shapes(preset: str):
    # (mode, b, s, h, kvh, d): prefill = causal flash over s; decode =
    # one token against an s-slot KV cache.
    smoke = [("prefill", 1, 256, 8, 2, 64), ("decode", 4, 1024, 8, 2, 64)]
    default = smoke + [
        ("prefill", 1, 512, 8, 8, 64),    # MHA (h == kvh)
        ("prefill", 1, 1024, 8, 2, 64),   # GQA g=4
        ("prefill", 2, 512, 16, 4, 64),
        ("prefill", 1, 1024, 16, 1, 64),  # MQA (h >> kvh)
        ("decode", 8, 4096, 16, 4, 64),
        ("decode", 16, 1024, 16, 2, 64),
        ("decode", 4, 8192, 8, 8, 64),    # big cache: memory-bound
    ]
    full = default + [
        ("prefill", 1, 2048, 8, 2, 64),
        ("decode", 32, 4096, 32, 8, 128),
    ]
    return {"smoke": smoke, "default": default, "full": full}[preset]


def _ssm_shapes(preset: str):
    # (b, s, h, p, n)
    smoke = [(1, 256, 8, 64, 64)]
    default = smoke + [
        (2, 1024, 8, 64, 64),
        (1, 512, 8, 64, 64),
        (4, 512, 4, 32, 64),
        (2, 2048, 4, 64, 32),
    ]
    full = default + [(4, 2048, 8, 64, 64), (1, 4096, 16, 64, 64)]
    return {"smoke": smoke, "default": default, "full": full}[preset]


def _gemm_row(m, k, n):
    return {
        "family": "gemm",
        "label": f"gemm_{m}x{k}x{n}",
        "params": {"m": m, "k": k, "n": n},
        "flops": 2.0 * m * k * n,
        "bytes": float(_BF16 * (m * k + k * n + m * n)),
    }


def _attention_row(mode, b, s, h, kvh, d):
    if mode == "prefill":
        flops = 4.0 * b * h * s * s * d * 0.5  # causal: half the mask
        byts = float(_F32 * (2 * b * s * h * d + 2 * b * s * kvh * d))
    else:  # decode: 1 query token vs an s-slot cache
        flops = 4.0 * b * h * s * d
        byts = float(_F32 * (2 * b * s * kvh * d + 2 * b * h * d))
    return {
        "family": "attention",
        "label": f"attn_{mode}_b{b}_s{s}_h{h}x{kvh}_d{d}",
        "params": {"mode": mode, "b": b, "s": s, "h": h, "kvh": kvh, "d": d},
        "flops": flops,
        "bytes": byts,
    }


def _ssm_row(b, s, h, p, n):
    t = min(_SSM_CHUNK, s)
    flops = 4.0 * b * s * h * n * p + 2.0 * b * s * t * h * (n + p)
    byts = float(_F32 * (2 * b * s * h * p + 2 * b * s * h * n + b * s * h))
    return {
        "family": "ssm",
        "label": f"ssm_b{b}_s{s}_h{h}_p{p}_n{n}",
        "params": {"b": b, "s": s, "h": h, "p": p, "n": n},
        "flops": flops,
        "bytes": byts,
    }


def shape_grid(spec: CalibrateSpec) -> list[dict]:
    """The calibration rows for a spec: one dict per (family, shape)
    with the analytic FLOP / byte counts and the holdout flag (every
    ``holdout_every``-th row *within each family* is held out, so all
    families contribute to both fit and holdout sets)."""
    rows: list[dict] = []
    for family in spec.families:
        if family == "gemm":
            fam_rows = [_gemm_row(*s) for s in _gemm_shapes(spec.preset)]
        elif family == "attention":
            fam_rows = [_attention_row(*s) for s in _attention_shapes(spec.preset)]
        else:
            fam_rows = [_ssm_row(*s) for s in _ssm_shapes(spec.preset)]
        for i, row in enumerate(fam_rows):
            row["holdout"] = bool(
                spec.holdout_every and (i % spec.holdout_every
                                        == spec.holdout_every - 1)
            )
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel_fn(family: str, mode: str = ""):
    """Cached wrapper per (family, mode) over the port's kernel wrappers:
    ``dos_matmul`` (bf16), ``flash_attention`` (causal),
    ``decode_attention`` and ``ssm_scan``'s output. On CUDA tensors each
    launches its kernel (built at first use) or raises; on CPU tensors
    each runs its plain version."""
    from ..kernels.dos_matmul import dos_matmul
    from ..kernels.flash_attention import decode_attention, flash_attention
    from ..kernels.ssm_scan import ssm_scan

    if family == "gemm":
        return lambda a, b: dos_matmul(a, b)
    if family == "attention" and mode == "prefill":
        return lambda q, k, v: flash_attention(q, k, v, causal=True)
    if family == "attention":
        return lambda q, kc, vc, length: decode_attention(q, kc, vc, length=length)
    if family == "ssm":
        return lambda u, ld, B, C: ssm_scan(u, ld, B, C)[0]
    raise ValueError(f"unknown kernel family {family!r}")


def _build_inputs(row: dict, seed: int, device="cpu"):
    """The row's inputs, drawn with numpy from ``seed`` exactly as the JAX
    package draws them (f64 normals rounded to f32, then to bf16 for the
    GEMM operands), on ``device``."""
    rng = np.random.default_rng(seed)
    p = row["params"]
    family = row["family"]

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device=device, dtype=dtype)

    if family == "gemm":
        a = t(rng.normal(size=(p["m"], p["k"])), torch.bfloat16)
        b = t(rng.normal(size=(p["k"], p["n"])), torch.bfloat16)
        return (a, b)
    if family == "attention" and p["mode"] == "prefill":
        q = t(rng.normal(size=(p["b"], p["s"], p["h"], p["d"])))
        k = t(rng.normal(size=(p["b"], p["s"], p["kvh"], p["d"])))
        v = t(rng.normal(size=(p["b"], p["s"], p["kvh"], p["d"])))
        return (q, k, v)
    if family == "attention":
        q = t(rng.normal(size=(p["b"], 1, p["h"], p["d"])))
        kc = t(rng.normal(size=(p["b"], p["s"], p["kvh"], p["d"])))
        vc = t(rng.normal(size=(p["b"], p["s"], p["kvh"], p["d"])))
        return (q, kc, vc, int(p["s"]))
    u = t(rng.normal(size=(p["b"], p["s"], p["h"], p["p"])))
    ld = t(-rng.uniform(0.01, 0.2, size=(p["b"], p["s"], p["h"])))
    B = t(rng.normal(size=(p["b"], p["s"], p["h"], p["n"])))
    C = t(rng.normal(size=(p["b"], p["s"], p["h"], p["n"])))
    return (u, ld, B, C)


def measure_row(row: dict, *, reps: int = 5, warmup: int = 2,
                seed: int = 0, device=None) -> dict:
    """Measure one calibration row on ``device`` (``None``: the card):
    one untimed call (on a family's first row it builds and loads the
    kernel), ``warmup`` untimed calls, then ``reps`` individually-timed
    calls, each on the host clock up to a device synchronize. Returns a
    JSON-safe record with the median time and achieved FLOP/s / GB/s."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    args = _build_inputs(row, seed, dev)
    fn = _kernel_fn(row["family"], row["params"].get("mode", ""))
    fn(*args)  # the kernel's build and load at first use: never timed
    sync()
    for _ in range(max(warmup, 1)):
        fn(*args)
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    t_s = float(np.median(ts))
    out = dict(row)
    out.update(
        t_s=t_s,
        spread_s=float(max(ts) - min(ts)),
        reps=int(reps),
        achieved_gflops=row["flops"] / t_s / 1e9,
        achieved_gbs=row["bytes"] / t_s / 1e9,
    )
    return out


# ---------------------------------------------------------------------------
# Fit
# ---------------------------------------------------------------------------

def _lsq_rate(work: np.ndarray, t: np.ndarray) -> float:
    """Closed-form relative-error-weighted LSQ for t ~ work / rate:
    minimize sum(((t_i - work_i/rate) / t_i)^2) over 1/rate."""
    x = float(np.sum(work / t) / np.sum((work / t) ** 2) )
    return 1.0 / x if x > 0 else math.inf


def _predict(rows_f, rows_b, rates: dict, bw: float, overhead: dict,
             families) -> np.ndarray:
    """Predicted step time per row via ``roofline_terms_batched``."""
    from ..analysis.roofline import roofline_terms_batched

    rate = np.asarray([rates[f] for f in families], dtype=np.float64)
    over = np.asarray([overhead.get(f, 0.0) for f in families],
                      dtype=np.float64)
    terms = roofline_terms_batched(rows_f / rate, rows_b / bw, over)
    return np.asarray(terms["step_s"], dtype=np.float64)


def fit_rows(measured: list[dict], spec: CalibrateSpec,
             iters: int = 40) -> dict:
    """Alternating least-squares roofline fit over measured rows.

    Three fitted parameter groups, all slotting into the combiner's
    existing terms: per-family effective compute rates, one shared
    DRAM bandwidth, and a per-family *launch overhead* riding the
    additive ``collective_s`` slot (per-call dispatch cost — without
    it every small shape reads as an impossibly slow rate, the classic
    roofline-fitting trap). Each iteration assigns every fit row to
    its binding term (compute vs memory) under the current parameters
    — via ``roofline_terms_batched``, the same combiner every report
    uses — then re-fits each group in closed form from its assigned
    rows (relative-error-weighted LSQ on the overhead-stripped
    residual). Returns the payload dict (fit + per-bucket errors + the
    ``CalibratedBandwidth`` artifact).
    """
    from ..analysis.roofline import roofline_terms_batched

    fams = tuple(sorted({r["family"] for r in measured}))
    F = np.asarray([r["flops"] for r in measured], dtype=np.float64)
    B = np.asarray([r["bytes"] for r in measured], dtype=np.float64)
    t = np.asarray([r["t_s"] for r in measured], dtype=np.float64)
    fam = np.asarray([r["family"] for r in measured])
    hold = np.asarray([bool(r.get("holdout")) for r in measured])
    fit = ~hold

    # init: the achieved-rate ceilings (no row can beat its own rate)
    rates = {
        f: float(np.max((F / t)[fit & (fam == f)], initial=1e9)) for f in fams
    }
    bw = float(np.max((B / t)[fit], initial=1e9))
    over = {f: 0.0 for f in fams}
    for _ in range(iters):
        over_vec = np.asarray([over[x] for x in fam], dtype=np.float64)
        tr = np.maximum(t - over_vec, 1e-9)  # overhead-stripped residual
        rate_vec = np.asarray([rates[x] for x in fam], dtype=np.float64)
        dom = roofline_terms_batched(F / rate_vec, B / bw, 0.0)["dominant"]
        new_rates = dict(rates)
        for f in fams:
            m = fit & (fam == f) & (dom == "compute")
            if m.any():
                new_rates[f] = _lsq_rate(F[m], tr[m])
        mmem = fit & (dom == "memory")
        new_bw = _lsq_rate(B[mmem], tr[mmem]) if mmem.any() else bw
        # overhead: weighted LSQ of the leftover t - max(F/r, B/bw),
        # clipped at 0 (an overhead cannot be negative)
        rate_vec = np.asarray([new_rates[x] for x in fam], dtype=np.float64)
        step = np.maximum(F / rate_vec, B / new_bw)
        new_over = {}
        for f in fams:
            m = fit & (fam == f)
            if m.any():
                w2 = 1.0 / t[m] ** 2
                new_over[f] = max(
                    0.0, float(np.sum((t[m] - step[m]) * w2) / np.sum(w2))
                )
            else:
                new_over[f] = over[f]
        if new_rates == rates and new_bw == bw and new_over == over:
            break
        rates, bw, over = new_rates, new_bw, new_over

    pred = _predict(F, B, rates, bw, over, fam)
    rel = np.abs(pred - t) / t
    # the uncalibrated model: nominal peak FLOP/s and HBM bandwidth
    nominal = {f: float(HW.TPU_PEAK_FLOPS_BF16) for f in fams}
    pred0 = _predict(F, B, nominal, float(HW.TPU_HBM_BW), {}, fam)
    rel0 = np.abs(pred0 - t) / t

    def _med(mask) -> float:
        return float(np.median(rel[mask])) if mask.any() else math.nan

    errors = {
        "fit_median_rel_err": _med(fit),
        "holdout_median_rel_err": _med(hold) if hold.any() else _med(fit),
        "uncalibrated_holdout_median_rel_err": float(
            np.median(rel0[hold if hold.any() else fit])
        ),
        "per_family_median_rel_err": {f: _med(fam == f) for f in fams},
    }
    efficiency = {f: rates[f] / float(HW.TPU_PEAK_FLOPS_BF16) for f in fams}
    artifact = CalibratedBandwidth(
        bandwidth=BandwidthSpec(dram_gbs=bw / 1e9),
        efficiency=efficiency,
        peak_flops=float(HW.TPU_PEAK_FLOPS_BF16),
        diagnostics=dict(
            errors, n_rows=len(measured), n_holdout=int(hold.sum()),
            families=list(fams), preset=spec.preset,
            overhead_s={f: over[f] for f in fams},
        ),
    )
    for r, p_, e_, e0 in zip(measured, pred, rel, rel0):
        r["pred_s"] = float(p_)
        r["rel_err"] = float(e_)
        r["rel_err_uncalibrated"] = float(e0)
    return {
        "rows": measured,
        "rates_flops": {f: rates[f] for f in fams},
        "dram_gbs_fitted": bw / 1e9,
        "efficiency": efficiency,
        "overhead_s": {f: over[f] for f in fams},
        "errors": errors,
        "artifact": artifact,
    }


# ---------------------------------------------------------------------------
# Artifact
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CalibratedBandwidth:
    """A fitted memory-system + efficiency artifact.

    - ``bandwidth``: the fitted ``BandwidthSpec`` (measured DRAM
      bandwidth; SRAM/vlink stay unbounded — they are not observable
      from single-chip wall time). This is what
      ``AnalysisSpec(bandwidth=...)`` consumes: passing the artifact
      (or its dict form) to any Study unwraps to this spec, so a
      JSON-round-tripped artifact reproduces bit-identical results.
    - ``efficiency``: per-family effective compute rate as a fraction
      of ``peak_flops``. The ``'gemm'`` entry calibrates the GEMM
      dataflows (dos/ws/is map the same MACs; ``dos_matmul`` is the
      dOS kernel) — ``efficiency_for`` exposes that mapping.
    - ``diagnostics``: fit/holdout error summary and provenance.
    """

    bandwidth: BandwidthSpec
    efficiency: dict
    peak_flops: float
    diagnostics: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if isinstance(self.bandwidth, dict):
            object.__setattr__(
                self, "bandwidth", BandwidthSpec.from_dict(self.bandwidth)
            )
        object.__setattr__(
            self, "efficiency",
            {str(k): float(v) for k, v in dict(self.efficiency).items()},
        )
        object.__setattr__(self, "peak_flops", float(self.peak_flops))

    def efficiency_for(self, dataflow: str) -> float:
        """Effective-compute factor for a GEMM dataflow (dos/os/ws/is
        all map MACs onto the same array; the measured GEMM efficiency
        calibrates them jointly). Falls back to 1.0 (nominal)."""
        if dataflow in self.efficiency:
            return self.efficiency[dataflow]
        return self.efficiency.get("gemm", 1.0)

    def to_dict(self) -> dict:
        return {
            "calibrated": True,
            "bandwidth": self.bandwidth.to_dict(),
            "efficiency": dict(self.efficiency),
            "peak_flops": self.peak_flops,
            "diagnostics": self.diagnostics,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CalibratedBandwidth":
        return cls(
            bandwidth=BandwidthSpec.from_dict(d["bandwidth"]),
            efficiency=d.get("efficiency", {}),
            peak_flops=d.get("peak_flops", HW.TPU_PEAK_FLOPS_BF16),
            diagnostics=d.get("diagnostics", {}),
        )


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------

def run_calibration(spec: CalibrateSpec | None = None, *,
                    measured: list[dict] | None = None, device=None) -> dict:
    """Sweep + measure + fit in one call (the benchmark / direct-use
    path). ``measured`` (pre-recorded rows) skips measurement — the fit
    is then deterministic. ``device``: where the kernels run (``None``:
    the card; a row whose kernel fails to build or launch raises)."""
    spec = spec or CalibrateSpec()
    if measured is None:
        dev = resolve_device(device)
        measured = [
            measure_row(row, reps=spec.reps, warmup=spec.warmup,
                        seed=spec.seed, device=dev)
            for row in shape_grid(spec)
        ]
    return fit_rows(measured, spec)
