"""Bandwidth-aware runtime model: DRAM, SRAM and vertical-link limits.

The paper's 9.14x 3D-vs-2D speedup (Figs. 5-7) assumes every operand
is on-chip the cycle the array wants it — a *compute-bound* mapping.
Its own TSV/MIV discussion (Sec. III-B) and the memory-bandwidth
characterization in "Towards 3D AI Hardware" make clear that whether a
stacked design realizes that speedup is decided by three resources the
runtime model of Eqs. 1/2 does not see:

- **DRAM bandwidth** [GB/s]: operands that miss on-chip SRAM must
  stream from DRAM; a design whose traffic-per-cycle exceeds the DRAM
  interface stalls the array.
- **On-chip SRAM capacity per tier** [bytes]: decides *how much*
  DRAM traffic there is (operand reuse across array folds) and, below
  the minimal working set, whether the design can run at all — SRAM
  capacity joins thermal as a first-class feasibility mask.
- **Vertical-link bandwidth** [bytes/cycle per tier boundary]: the dOS
  dataflow pushes one partial-sum plane (R x C accumulator words) down
  every tier boundary per fold. MIVs are small enough ([21], ~0.05
  um^2) to afford one full 17-bit bus per MAC pile; TSVs (~30 um^2
  with keep-out [20]) force bus sharing — the technology choice
  becomes a *bandwidth* distinction, not just a capacitance one.

``gemm_traffic_batched`` computes, for a whole batch of (workload,
design) pairs at once, the DRAM bytes, vertical-link bytes and
minimum SRAM working set of a GEMM on an (R, C, L) array under a
``BandwidthSpec``; ``roofline_cycles`` combines the compute cycles of
Eqs. 1/2 with the resulting memory/vertical-link service times into

    total_cycles = max(compute, memory, vlink)        (overlapped roofline)
    stall_cycles = total - compute
    bound        = argmax term ('compute' | 'memory' | 'vlink')

Everything here is exact float64 on integer-valued inputs (< 2^53) and
**identity-preserving**: the default ``BandwidthSpec()`` is unbounded
in every resource, which makes ``stall_cycles == 0``, ``bound ==
'compute'`` and every engine output bit-for-bit identical to the
bandwidth-oblivious path (regression-tested in
``tests/test_bandwidth.py``).

Reuse model (documented, deterministic). Traffic is counted per
logical tensor — A (M x K), B (K x N), O (M x N) — with reuse decided
by which resident tiles fit in the per-tier SRAM, checked in a fixed
order (stationary plane + stream buffers first, then A's resident
tile, then B's):

- os/dos (outputs stationary, K split over L tiers, Kt = ceil(K/L)):
  O is written once (accumulation stays on-chip / down the pile). A is
  read once iff its per-tier fold-row slice (R * Kt bytes_in) stays
  resident across the ceil(N/C) column folds, else ceil(N/C) times. B
  is read once iff its full per-tier slice (Kt * N bytes_in) fits too,
  else ceil(M/R) times.
- ws (weights stationary; M split over L tiers, Mt = ceil(M/L)): B is
  read once. A is read once iff its per-tier resident slice (Mt * K)
  fits, else ceil(N/R) times. Partial outputs accumulate across the
  ceil(K/C) contraction folds: spilled ((2*ceil(K/C) - 1) * M * N
  accumulator words) unless the per-tier accumulator tile (Mt * R)
  fits.
- is (inputs stationary; N split over L tiers, Nt = ceil(N/L)):
  symmetric to ws with A and B swapped.

Vertical links carry cross-tier traffic only for dOS (WS/IS-in-3D
split a temporal dimension and exchange nothing — see
``analytical.dataflow_dims``): per fold, each of the L - 1 tier
boundaries moves the R x C partial-sum plane (bytes_acc per word). The
boundaries operate concurrently, so the vlink service time is one
boundary's traffic over one boundary's bandwidth.

Fold traffic model (``fold_traffic_batched``, the ``tier_fold``
policy's pricing). A non-native fold re-partitions the GEMM across
tiers (see ``analytical.fold_dims``); the traffic convention is the
one the native model already uses: each tier's *own* operand and
result slices ride the planar distribution network and are priced by
the DRAM term alone — vertical links carry only the traffic the fold
*creates* across tier boundaries:

- folding the contraction dim K on ws/is mirrors dOS: every fold
  pushes an R x C partial-sum plane down each of the L - 1 boundaries;
- folding an output dim (m/n) makes the l tiers independent sub-GEMMs
  that all consume the *same* copy of the non-split operand (fold-m
  shares B, fold-n shares A): that operand's DRAM stream is multicast
  down the pile, so each of the L - 1 boundaries carries one copy of
  the stream and the vlink service time is the stream over one
  boundary's bandwidth. Splitting an output dim also *cuts* the shared
  operand's re-stream count (the per-tier fold count over the split
  dim shrinks by ~l) — the fold's DRAM-side win.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .ppa import constants as C

__all__ = [
    "BOUND_NAMES",
    "BandwidthSpec",
    "TSV_VLINK_SHARE",
    "bound_names",
    "fold_traffic_batched",
    "gemm_traffic_batched",
    "resolve_vlink_bits",
    "roofline_cycles",
]

#: bound classification order — ties break toward the earlier name, so
#: an exactly-balanced (or unbounded) design reports 'compute'.
BOUND_NAMES = ("compute", "memory", "vlink")

#: MAC piles per shared TSV bus. One 17-bit TSV bus per MAC pile would
#: cost VLINK_BITS * A_TSV_UM2 / A_MAC_UM2 ~ 128% area overhead — far
#: beyond the paper's "worst-case over-provisioning"; sharing one bus
#: among 16 piles brings the overhead to ~8% (the few-percent regime
#: the paper quotes for vias) at 1/16 the per-pile bandwidth. MIVs
#: (~0.05 um^2) afford a full bus per pile at < 0.3% overhead.
TSV_VLINK_SHARE = 16


@dataclasses.dataclass(frozen=True)
class BandwidthSpec:
    """Memory-system model for bandwidth-aware evaluation.

    Every default is *unbounded* — ``BandwidthSpec()`` produces zero
    stall cycles and leaves engine results bit-for-bit unchanged; cap
    a resource to make it bind.

    - ``dram_gbs``: DRAM/HBM interface bandwidth [GB/s; 1 GB = 1e9
      bytes]. At the paper's 1 GHz clock, ``dram_gbs`` is also the
      interface's bytes/cycle.
    - ``sram_kib_per_tier``: on-chip SRAM per tier [KiB]. Governs both
      operand reuse (how often A/B re-stream from DRAM) and the
      SRAM-capacity feasibility mask (designs whose minimal working
      set does not fit are infeasible).
    - ``vlink_bits_per_mac``: vertical bus width per MAC pile
      [bits/cycle], or ``'derived'`` to take the per-technology
      default (miv: the full ``VLINK_BITS``-bit bus; tsv: shared
      ``VLINK_BITS / TSV_VLINK_SHARE``; 2d: unbounded — no vertical
      links exist).
    - ``bytes_in``: operand word size [bytes] (paper: 8-bit operands).
    - ``bytes_acc``: partial-sum/accumulator word size [bytes]
      (paper: 16-bit accumulators).
    """

    dram_gbs: float = math.inf
    sram_kib_per_tier: float = math.inf
    vlink_bits_per_mac: float | str = math.inf
    bytes_in: int = 1
    bytes_acc: int = 2

    def __post_init__(self):
        for name in ("dram_gbs", "sram_kib_per_tier"):
            v = float(getattr(self, name))
            if not v > 0:
                raise ValueError(f"{name} must be > 0 (inf = unbounded), got {v}")
            object.__setattr__(self, name, v)
        v = self.vlink_bits_per_mac
        if isinstance(v, str):
            if v != "derived":
                raise ValueError(
                    f"vlink_bits_per_mac must be a positive width in bits or "
                    f"'derived', got {v!r}"
                )
        else:
            v = float(v)
            if not v > 0:
                raise ValueError(
                    f"vlink_bits_per_mac must be > 0 (inf = unbounded), got {v}"
                )
            object.__setattr__(self, "vlink_bits_per_mac", v)
        for name in ("bytes_in", "bytes_acc"):
            v = int(getattr(self, name))
            if v < 1:
                raise ValueError(f"{name} must be >= 1 byte, got {v}")
            object.__setattr__(self, name, v)

    @property
    def unbounded(self) -> bool:
        """True when no resource can bind (the identity spec)."""
        return (
            math.isinf(self.dram_gbs)
            and math.isinf(self.sram_kib_per_tier)
            and (
                not isinstance(self.vlink_bits_per_mac, str)
                and math.isinf(self.vlink_bits_per_mac)
            )
        )

    @property
    def sram_bytes(self) -> float:
        """Per-tier SRAM capacity [bytes]."""
        return self.sram_kib_per_tier * 1024.0

    @property
    def dram_bytes_per_cycle(self) -> float:
        """DRAM service rate [bytes/cycle] at the model's clock."""
        return self.dram_gbs * 1e9 / C.FREQ_HZ

    @classmethod
    def paper_default(cls) -> "BandwidthSpec":
        """A representative capped memory system for reports/benchmarks:
        HBM2-class 256 GB/s DRAM, 1 MiB SRAM per tier, per-technology
        derived vertical buses. On the Table-I workloads x the paper's
        budgets this splits the grid ~30/70 between compute- and
        memory-bound points (vlink binds only on short-fold decode-like
        shapes) and caps the headline 3D-vs-2D speedup well below the
        compute-bound prediction — the honest version of Fig. 5-7."""
        return cls(dram_gbs=256.0, sram_kib_per_tier=1024.0,
                   vlink_bits_per_mac="derived")

    def to_dict(self) -> dict:
        """JSON-compatible form (non-finite floats as strings — the
        study layer's strict-JSON convention); ``from_dict`` inverts."""
        out = dataclasses.asdict(self)
        for k, v in out.items():
            if isinstance(v, float) and math.isinf(v):
                out[k] = "Infinity"
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "BandwidthSpec":
        kw = dict(d)
        for k in ("dram_gbs", "sram_kib_per_tier"):
            if k in kw:
                kw[k] = float(kw[k])
        v = kw.get("vlink_bits_per_mac")
        if v is not None and not isinstance(v, str):
            kw["vlink_bits_per_mac"] = float(v)
        elif v == "Infinity":
            kw["vlink_bits_per_mac"] = math.inf
        return cls(**kw)


def resolve_vlink_bits(spec: BandwidthSpec, tech) -> np.ndarray:
    """Per-point vertical bus width [bits/cycle per MAC pile].

    ``tech`` is a ('2d'|'tsv'|'miv') array; '2d' is always unbounded
    (there is no vertical link to saturate).
    """
    tech = np.asarray(tech)
    if spec.vlink_bits_per_mac == "derived":
        bits = np.where(
            tech == "miv",
            float(C.VLINK_BITS),
            np.where(tech == "tsv", C.VLINK_BITS / TSV_VLINK_SHARE, np.inf),
        )
    else:
        bits = np.full(tech.shape, float(spec.vlink_bits_per_mac))
    return np.where(tech == "2d", np.inf, bits)


def _ceil(a, b):
    return np.floor((a + b - 1.0) / b)


def gemm_traffic_batched(dataflow: str, M, K, N, R, Cc, L, tech, spec: BandwidthSpec,
                         sram_bytes=None):
    """Traffic + working set of a GEMM batch on (R, C, L) arrays.

    All array arguments are flat int arrays of one dataflow group (the
    engine splits per dataflow); ``tech`` is a parallel str array.
    ``sram_bytes`` (optional) overrides ``spec.sram_bytes`` with a
    parallel per-element capacity array [bytes] — the engine passes it
    when the grid carries per-point SRAM axes (guided search over
    memory systems); ``None`` keeps the spec's scalar capacity.
    Returns a dict of float64 arrays, per batch element:

    - ``dram_bytes``: total DRAM traffic [bytes] under the module's
      reuse model (A + B + O);
    - ``vlink_bytes``: total cross-tier traffic [bytes] (all L - 1
      boundaries summed; 0 for ws/is and for L == 1);
    - ``vlink_cycles``: vertical-link service time [cycles] — one
      boundary's traffic over one boundary's bandwidth (boundaries run
      concurrently);
    - ``sram_need_bytes``: minimal per-tier working set [bytes]
      (stationary plane + double-buffered edge streams) — the
      SRAM-capacity feasibility threshold.
    """
    M, K, N, R, Cc, L = (np.asarray(x, dtype=np.float64) for x in (M, K, N, R, Cc, L))
    bi, ba = float(spec.bytes_in), float(spec.bytes_acc)
    sram = (
        spec.sram_bytes
        if sram_bytes is None
        else np.asarray(sram_bytes, dtype=np.float64)
    )
    vbits = resolve_vlink_bits(spec, tech)
    zeros = np.zeros_like(M)

    if dataflow in ("os", "dos"):
        Kt = _ceil(K, L)
        foldM = _ceil(M, R)
        foldN = _ceil(N, Cc)
        base = R * Cc * ba + 2.0 * (R + Cc) * bi
        a_tile = R * Kt * bi
        b_slice = Kt * N * bi
        reuse_a = base + a_tile <= sram
        reuse_b = reuse_a & (base + a_tile + b_slice <= sram)
        a_bytes = np.where(reuse_a, 1.0, foldN) * M * K * bi
        b_bytes = np.where(reuse_b, 1.0, foldM) * K * N * bi
        o_bytes = M * N * ba
        folds = foldM * foldN
        vlink_bytes = np.where(L > 1.0, (L - 1.0) * folds * R * Cc * ba, 0.0)
        with np.errstate(divide="ignore"):
            per_boundary_bw = R * Cc * vbits / 8.0  # bytes/cycle
            vlink_cycles = np.where(
                L > 1.0, folds * R * Cc * ba / per_boundary_bw, 0.0
            )
        return dict(
            dram_bytes=a_bytes + b_bytes + o_bytes,
            vlink_bytes=vlink_bytes,
            vlink_cycles=vlink_cycles,
            sram_need_bytes=base,
        )

    if dataflow == "ws":
        # N, K spatial; M temporal, split across tiers (no vlink traffic).
        Mt = _ceil(M, L)
        foldN = _ceil(N, R)
        foldK = _ceil(K, Cc)
        base = R * Cc * bi + 2.0 * (R * ba + Cc * bi)
        stationary_bytes = K * N * bi  # weights, loaded once
        a_resident = Mt * K * bi
        reuse_a = base + a_resident <= sram
        a_bytes = np.where(reuse_a, 1.0, foldN) * M * K * bi
        o_tile = Mt * R * ba
        o_fits = base + np.where(reuse_a, a_resident, 0.0) + o_tile <= sram
        o_bytes = np.where(o_fits, 1.0, 2.0 * foldK - 1.0) * M * N * ba
        return dict(
            dram_bytes=stationary_bytes + a_bytes + o_bytes,
            vlink_bytes=zeros,
            vlink_cycles=zeros,
            sram_need_bytes=base,
        )

    if dataflow == "is":
        # M, K spatial; N temporal, split across tiers (no vlink traffic).
        Nt = _ceil(N, L)
        foldM = _ceil(M, R)
        foldK = _ceil(K, Cc)
        base = R * Cc * bi + 2.0 * (R * ba + Cc * bi)
        stationary_bytes = M * K * bi  # inputs, loaded once
        b_resident = Nt * K * bi
        reuse_b = base + b_resident <= sram
        b_bytes = np.where(reuse_b, 1.0, foldM) * K * N * bi
        o_tile = Nt * R * ba
        o_fits = base + np.where(reuse_b, b_resident, 0.0) + o_tile <= sram
        o_bytes = np.where(o_fits, 1.0, 2.0 * foldK - 1.0) * M * N * ba
        return dict(
            dram_bytes=stationary_bytes + b_bytes + o_bytes,
            vlink_bytes=zeros,
            vlink_cycles=zeros,
            sram_need_bytes=base,
        )

    raise ValueError(f"unknown dataflow {dataflow!r}")


def fold_traffic_batched(fold, dataflow: str, M, K, N, R, Cc, L, tech,
                         spec: BandwidthSpec, sram_bytes=None):
    """Traffic + working set of a GEMM batch under a chosen tier fold.

    Same contract as ``gemm_traffic_batched`` (which it returns
    verbatim for the dataflow's native fold or ``fold=None`` — the
    identity that keeps the fixed/per_layer policies bit-stable), plus
    the two non-native folds per dataflow, priced under the module's
    fold traffic convention (module docstring): per-tier slices ride
    the planar network (DRAM term), vertical links carry only
    fold-created traffic — dOS-style partial-sum planes for a
    non-native fold-k, the shared operand's multicast stream for an
    output-dim fold. ``tests/oracle_fold.py`` reprices every branch
    with explicit per-tier/per-boundary loops; the differential tests
    assert bit-for-bit agreement.
    """
    from .analytical import native_fold

    if fold is None or fold == native_fold(dataflow):
        return gemm_traffic_batched(dataflow, M, K, N, R, Cc, L, tech, spec,
                                    sram_bytes=sram_bytes)
    M, K, N, R, Cc, L = (np.asarray(x, dtype=np.float64) for x in (M, K, N, R, Cc, L))
    bi, ba = float(spec.bytes_in), float(spec.bytes_acc)
    sram = (
        spec.sram_bytes
        if sram_bytes is None
        else np.asarray(sram_bytes, dtype=np.float64)
    )
    vbits = resolve_vlink_bits(spec, tech)

    def _stream_vlink(stream_bytes):
        # The shared operand's DRAM stream is multicast down the pile:
        # all L - 1 boundaries carry one copy each; service time is the
        # stream over one boundary's concurrent bandwidth.
        with np.errstate(divide="ignore"):
            per_boundary_bw = R * Cc * vbits / 8.0
            cycles = np.where(L > 1.0, stream_bytes / per_boundary_bw, 0.0)
        return np.where(L > 1.0, (L - 1.0) * stream_bytes, 0.0), cycles

    if dataflow in ("os", "dos"):
        base = R * Cc * ba + 2.0 * (R + Cc) * bi
        a_tile = R * K * bi  # full-K row tile: the fold keeps K whole
        if fold == "m":
            Mt = _ceil(M, L)
            foldMt = _ceil(Mt, R)
            foldN = _ceil(N, Cc)
            b_slice = K * N * bi  # B is shared whole across tiers
            reuse_a = base + a_tile <= sram
            reuse_b = reuse_a & (base + a_tile + b_slice <= sram)
            a_bytes = np.where(reuse_a, 1.0, foldN) * M * K * bi
            b_stream = np.where(reuse_b, 1.0, foldMt) * K * N * bi
            o_bytes = M * N * ba
            vlink_bytes, vlink_cycles = _stream_vlink(b_stream)
            return dict(
                dram_bytes=a_bytes + b_stream + o_bytes,
                vlink_bytes=vlink_bytes,
                vlink_cycles=vlink_cycles,
                sram_need_bytes=base,
            )
        if fold == "n":
            Nt = _ceil(N, L)
            foldM = _ceil(M, R)
            foldNt = _ceil(Nt, Cc)
            b_slice = K * Nt * bi  # per-tier column slice of B
            reuse_a = base + a_tile <= sram
            reuse_b = reuse_a & (base + a_tile + b_slice <= sram)
            a_stream = np.where(reuse_a, 1.0, foldNt) * M * K * bi
            b_bytes = np.where(reuse_b, 1.0, foldM) * K * N * bi
            o_bytes = M * N * ba
            vlink_bytes, vlink_cycles = _stream_vlink(a_stream)
            return dict(
                dram_bytes=a_stream + b_bytes + o_bytes,
                vlink_bytes=vlink_bytes,
                vlink_cycles=vlink_cycles,
                sram_need_bytes=base,
            )

    if dataflow == "ws":
        base = R * Cc * bi + 2.0 * (R * ba + Cc * bi)
        stationary_bytes = K * N * bi  # weights, loaded once
        if fold == "k":
            # dOS-style contraction split: partial-sum planes down the pile.
            Kt = _ceil(K, L)
            foldN = _ceil(N, R)
            foldKt = _ceil(Kt, Cc)
            a_resident = M * Kt * bi  # per-tier K slice, full temporal M
            reuse_a = base + a_resident <= sram
            a_bytes = np.where(reuse_a, 1.0, foldN) * M * K * bi
            o_tile = M * R * ba
            o_fits = base + np.where(reuse_a, a_resident, 0.0) + o_tile <= sram
            o_bytes = np.where(o_fits, 1.0, 2.0 * foldKt - 1.0) * M * N * ba
            folds = foldN * foldKt
            vlink_bytes = np.where(L > 1.0, (L - 1.0) * folds * R * Cc * ba, 0.0)
            with np.errstate(divide="ignore"):
                per_boundary_bw = R * Cc * vbits / 8.0
                vlink_cycles = np.where(
                    L > 1.0, folds * R * Cc * ba / per_boundary_bw, 0.0
                )
            return dict(
                dram_bytes=stationary_bytes + a_bytes + o_bytes,
                vlink_bytes=vlink_bytes,
                vlink_cycles=vlink_cycles,
                sram_need_bytes=base,
            )
        if fold == "n":
            Nt = _ceil(N, L)
            foldNt = _ceil(Nt, R)
            foldK = _ceil(K, Cc)
            a_resident = M * K * bi  # every tier consumes all of A
            reuse_a = base + a_resident <= sram
            a_stream = np.where(reuse_a, 1.0, foldNt) * M * K * bi
            o_tile = M * R * ba
            o_fits = base + np.where(reuse_a, a_resident, 0.0) + o_tile <= sram
            o_bytes = np.where(o_fits, 1.0, 2.0 * foldK - 1.0) * M * N * ba
            vlink_bytes, vlink_cycles = _stream_vlink(a_stream)
            return dict(
                dram_bytes=stationary_bytes + a_stream + o_bytes,
                vlink_bytes=vlink_bytes,
                vlink_cycles=vlink_cycles,
                sram_need_bytes=base,
            )

    if dataflow == "is":
        base = R * Cc * bi + 2.0 * (R * ba + Cc * bi)
        stationary_bytes = M * K * bi  # inputs, loaded once
        if fold == "k":
            Kt = _ceil(K, L)
            foldM = _ceil(M, R)
            foldKt = _ceil(Kt, Cc)
            b_resident = N * Kt * bi
            reuse_b = base + b_resident <= sram
            b_bytes = np.where(reuse_b, 1.0, foldM) * K * N * bi
            o_tile = N * R * ba
            o_fits = base + np.where(reuse_b, b_resident, 0.0) + o_tile <= sram
            o_bytes = np.where(o_fits, 1.0, 2.0 * foldKt - 1.0) * M * N * ba
            folds = foldM * foldKt
            vlink_bytes = np.where(L > 1.0, (L - 1.0) * folds * R * Cc * ba, 0.0)
            with np.errstate(divide="ignore"):
                per_boundary_bw = R * Cc * vbits / 8.0
                vlink_cycles = np.where(
                    L > 1.0, folds * R * Cc * ba / per_boundary_bw, 0.0
                )
            return dict(
                dram_bytes=stationary_bytes + b_bytes + o_bytes,
                vlink_bytes=vlink_bytes,
                vlink_cycles=vlink_cycles,
                sram_need_bytes=base,
            )
        if fold == "m":
            Mt = _ceil(M, L)
            foldMt = _ceil(Mt, R)
            foldK = _ceil(K, Cc)
            b_resident = N * K * bi  # every tier consumes all of B
            reuse_b = base + b_resident <= sram
            b_stream = np.where(reuse_b, 1.0, foldMt) * K * N * bi
            o_tile = N * R * ba
            o_fits = base + np.where(reuse_b, b_resident, 0.0) + o_tile <= sram
            o_bytes = np.where(o_fits, 1.0, 2.0 * foldK - 1.0) * M * N * ba
            vlink_bytes, vlink_cycles = _stream_vlink(b_stream)
            return dict(
                dram_bytes=stationary_bytes + b_stream + o_bytes,
                vlink_bytes=vlink_bytes,
                vlink_cycles=vlink_cycles,
                sram_need_bytes=base,
            )

    raise ValueError(f"unknown fold {fold!r} for dataflow {dataflow!r}")


def roofline_cycles(compute_cycles, mem_cycles, vlink_cycles):
    """Overlapped three-term roofline [cycles].

    Returns ``(total, stall, bound_idx)``: ``total = max(compute,
    memory, vlink)`` (the three engines run concurrently; the slowest
    paces the GEMM), ``stall = total - compute`` (extra cycles the MAC
    array waits), ``bound_idx`` indexes ``BOUND_NAMES`` with ties
    breaking toward compute — an unbounded spec therefore reports
    'compute' everywhere with exactly zero stall.
    """
    compute = np.asarray(compute_cycles, dtype=np.float64)
    mem = np.asarray(mem_cycles, dtype=np.float64)
    vlink = np.asarray(vlink_cycles, dtype=np.float64)
    total = np.maximum(compute, np.maximum(mem, vlink))
    stall = total - compute
    bound_idx = np.where(
        vlink > np.maximum(compute, mem),
        2,
        np.where(mem > compute, 1, 0),
    )
    return total, stall, bound_idx


def bound_names(bound_idx) -> np.ndarray:
    """Index array -> ('compute'|'memory'|'vlink') str array."""
    return np.asarray(BOUND_NAMES)[np.asarray(bound_idx, dtype=np.int64)]
