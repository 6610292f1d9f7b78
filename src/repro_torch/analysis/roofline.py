"""Three-term roofline from a compiled dry-run artifact.

    compute term    = HLO_FLOPs / peak_FLOP/s            (per chip)
    memory term     = HLO_bytes / HBM_bw                 (per chip)
    collective term = collective_wire_bytes / link_bw    (per chip)

``cost_analysis()`` on the SPMD-compiled module is already per-device
(flops / bytes of one chip's program). Collective bytes are NOT in
cost_analysis: we parse the compiled HLO text, take every
all-reduce / all-gather / reduce-scatter / all-to-all /
collective-permute result shape (per-device under SPMD) and convert to
ring wire-bytes with the op-specific factor:

    all-reduce        2 (g-1)/g * bytes      (reduce-scatter + all-gather ring)
    all-gather          (g-1)/g * bytes      (result bytes = full buffer)
    reduce-scatter      (g-1)   * bytes      (result bytes = one shard)
    all-to-all          (g-1)/g * bytes
    collective-permute  1       * bytes

Hardware model (TPU v5e): 197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s/link
ICI (one link per axis direction assumed busy — the pessimistic single-
link model; overlap across axes is an optimization the §Perf loop can
claim explicitly).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from ..core.ppa import constants as HW

__all__ = [
    "CollectiveStats",
    "parse_collectives",
    "Roofline",
    "roofline_from_artifact",
    "roofline_terms_batched",
]

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s+(?:\(([^)]*)\)|(\w+)\[([\d,]*)\][^ ]*)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)
_TUPLE_PART = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(dtype: str, dims: str) -> float:
    bpe = _DTYPE_BYTES.get(dtype)
    if bpe is None:
        return 0.0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return float(n * bpe)


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float  # ring wire bytes per device (factor-adjusted)
    result_bytes: float  # raw result bytes
    counts: dict  # op -> count
    by_op_bytes: dict  # op -> wire bytes


def parse_collectives(hlo_text: str) -> CollectiveStats:
    counts: dict = {}
    by_op: dict = {}
    wire = 0.0
    raw = 0.0
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        tuple_body, dtype, dims, op = m.groups()
        if tuple_body is not None:
            rb = sum(
                _shape_bytes(d, s) for d, s in _TUPLE_PART.findall(tuple_body)
            )
        else:
            rb = _shape_bytes(dtype, dims)
        g = _group_size(line)
        if op == "all-reduce":
            factor = 2.0 * (g - 1) / g
        elif op == "all-gather":
            factor = (g - 1) / g
        elif op == "reduce-scatter":
            factor = float(g - 1)
        elif op == "all-to-all":
            factor = (g - 1) / g
        else:  # collective-permute
            factor = 1.0
        counts[op] = counts.get(op, 0) + 1
        by_op[op] = by_op.get(op, 0.0) + rb * factor
        wire += rb * factor
        raw += rb
    return CollectiveStats(wire_bytes=wire, result_bytes=raw, counts=counts, by_op_bytes=by_op)


def _group_size(line: str) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return max(len(m.group(1).split(",")), 1)
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return max(int(m.group(2)), 1)
    return 2  # unknown grouping: assume a pair (conservative-low)


def roofline_terms_batched(
    compute_s,
    memory_s,
    collective_s,
    memory_s_kernel=0.0,
):
    """Batched three-term artifact roofline — the one combiner.

    Vectorized over broadcastable per-cell term arrays [seconds].
    Returns a dict of arrays: ``step_s`` (max(compute, effective
    memory) + collective — compute/memory overlap on TPU, the
    collective is the paper-faithful serialized adder pile),
    ``stall_s`` (step minus compute: time the MXUs are not the
    bottleneck), and ``dominant`` ('compute' | 'memory' | 'collective',
    ties toward the earlier name). ``memory_s_kernel`` > 0 overrides
    ``memory_s`` per cell (Pallas kernels keep flash/SSD blocks in
    VMEM; the jnp-fallback HLO overstates those bytes).

    The scalar ``Roofline`` properties are batch-of-one wrappers over
    this function, so per-artifact and batched tables can never drift
    (regression-pinned on the parse fixtures) — the same
    scalar-wraps-batched contract as ``core.engine`` /
    ``core.bandwidth.roofline_cycles``, which applies the overlapped
    max to engine cycles instead of artifact seconds.
    """
    compute, mem, mem_k, coll = np.broadcast_arrays(
        *(np.asarray(x, dtype=np.float64)
          for x in (compute_s, memory_s, memory_s_kernel, collective_s))
    )
    mem_eff = np.where(mem_k > 0, mem_k, mem)
    step = np.maximum(compute, mem_eff) + coll
    names = np.asarray(("compute", "memory", "collective"))
    dominant = names[
        np.where(
            coll > np.maximum(compute, mem_eff),
            2,
            np.where(mem_eff > compute, 1, 0),
        )
    ]
    return {
        "memory_s_effective": mem_eff,
        "step_s": step,
        "stall_s": step - compute,
        "dominant": dominant,
    }


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float  # per device
    hlo_bytes: float  # per device
    wire_bytes: float  # per device
    model_flops: float  # 6*N*D useful flops, global
    compute_s: float
    memory_s: float
    collective_s: float
    collective_counts: dict
    # kernel-aware analytic HBM traffic (Pallas kernels keep flash/SSD
    # blocks in VMEM; the jnp-fallback HLO overstates those bytes).
    memory_s_kernel: float = 0.0

    def _terms(self) -> dict:
        """Batch-of-one delegation to ``roofline_terms_batched``."""
        return roofline_terms_batched(
            self.compute_s, self.memory_s, self.collective_s,
            self.memory_s_kernel,
        )

    @property
    def dominant(self) -> str:
        return str(np.asarray(self._terms()["dominant"]).reshape(-1)[0])

    @property
    def step_s(self) -> float:
        """Pessimistic step estimate: max(compute, kernel-true memory)
        + collective (the paper-faithful sequential adder pile)."""
        return float(np.asarray(self._terms()["step_s"]).reshape(-1)[0])

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (HLO_FLOPs * chips): remat/dispatch overhead."""
        total_hlo = self.hlo_flops * self.n_chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def mfu(self) -> float:
        """Model-flops utilization at the roofline step estimate."""
        denom = self.step_s * self.n_chips * HW.TPU_PEAK_FLOPS_BF16
        return self.model_flops / denom if denom else 0.0

    @property
    def roofline_fraction(self) -> float:
        """max-term / step: 1.0 = the dominant term is the whole step."""
        m = max(self.compute_s, self.memory_s, self.collective_s)
        return m / self.step_s if self.step_s else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            dominant=self.dominant,
            step_s=self.step_s,
            useful_ratio=self.useful_ratio,
            mfu=self.mfu,
        )
        return d


def roofline_from_artifact(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    n_chips: int,
    cost: dict,
    coll: CollectiveStats,
    model_flops: float,
    kernel_bytes: float = 0.0,
) -> Roofline:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    return Roofline(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        n_chips=n_chips,
        hlo_flops=flops,
        hlo_bytes=byts,
        wire_bytes=coll.wire_bytes,
        model_flops=model_flops,
        compute_s=flops / HW.TPU_PEAK_FLOPS_BF16,
        memory_s=byts / HW.TPU_HBM_BW,
        collective_s=coll.wire_bytes / HW.TPU_ICI_BW_PER_LINK,
        collective_counts=coll.counts,
        memory_s_kernel=kernel_bytes / HW.TPU_HBM_BW,
    )
