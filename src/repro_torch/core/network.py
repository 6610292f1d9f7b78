"""Network-level lowering: model-zoo configs -> per-layer GEMM streams.

The paper evaluates 3D-vs-2D trade-offs on isolated GEMM layers
(Table I), but its architectural claims are about whole networks
running on one accelerator. This module closes that gap: it walks any
``ArchConfig`` from ``repro_torch.configs`` and emits the complete per-layer
GEMM workload stream for a ``ShapeConfig`` — every weight GEMM the
network executes, with its multiplicity — so the batched evaluation
engine (``core.engine.schedule``) can reduce a whole network to
end-to-end cycles/energy/EDP under a thermal feasibility constraint.

Lowering conventions (documented per family in the ``_lower_*``
helpers):

- The stream describes ONE network execution: a full forward over the
  global batch for ``train``/``prefill`` shapes (per-sequence GEMMs
  with ``count`` multiplied by the batch), and one batched decode step
  (M = global_batch) for ``decode`` shapes.
- Only *matrix-multiply* work is lowered — exactly what Eqs. 1/2
  model: attention q/k/v/o projections, MLP up/gate/down, MoE routers
  + routed/shared experts (with expected routed token counts), SSM
  in/out projections and the depthwise conv as an im2col GEMM, and
  the logits/unembedding GEMM. Embedding lookups (gathers), softmax,
  norms and the SSM recurrence itself (outer-product state updates,
  K = 1 per step) are not GEMMs and are excluded. Attention
  score/value products (activation x activation) are likewise outside
  the paper's weight-GEMM model and excluded.
- Identical (M, K, N) GEMMs are merged with summed counts, so the
  stream stays compact (one entry per unique shape) while the engine
  weights totals by ``count``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import ArchConfig, Mode, ShapeConfig

__all__ = [
    "LayerGemm",
    "WorkloadStream",
    "lower_network",
    "lower_zoo",
    "CONV_WIDTH",
]

#: depthwise-conv kernel taps lowered as the K dim of an im2col GEMM.
CONV_WIDTH = 4


@dataclasses.dataclass(frozen=True)
class LayerGemm:
    """One GEMM shape in a network stream with its multiplicity."""

    name: str
    M: int
    K: int
    N: int
    #: how many times this GEMM runs in one network execution
    count: int

    @property
    def macs(self) -> int:
        return self.M * self.K * self.N

    @property
    def total_macs(self) -> int:
        return self.macs * self.count


@dataclasses.dataclass(frozen=True)
class WorkloadStream:
    """The full per-layer GEMM stream of one (arch, shape) cell.

    ``workloads`` / ``counts`` are the arrays ``core.engine.schedule``
    consumes; ``gemms`` keeps the named per-entry breakdown for
    reports. Entries are unique (M, K, N) shapes (merged on lowering).
    ``layer_names`` aligns with ``workloads`` rows — reports that
    attach per-layer decisions (e.g. the schedule's ``tier_fold``
    fold-per-layer assignment) key on it.
    """

    arch: str
    shape: str
    mode: Mode
    gemms: tuple[LayerGemm, ...]

    @property
    def workloads(self) -> np.ndarray:
        """(n, 3) int64 of unique (M, K, N) rows."""
        return np.array([[g.M, g.K, g.N] for g in self.gemms], dtype=np.int64)

    @property
    def counts(self) -> np.ndarray:
        """(n,) int64 multiplicity per unique GEMM."""
        return np.array([g.count for g in self.gemms], dtype=np.int64)

    @property
    def layer_names(self) -> tuple[str, ...]:
        """Per-entry names, aligned with ``workloads`` / ``counts``."""
        return tuple(g.name for g in self.gemms)

    @property
    def total_macs(self) -> int:
        return int(sum(g.total_macs for g in self.gemms))

    @property
    def n_gemm_invocations(self) -> int:
        return int(self.counts.sum())

    def compulsory_bytes(self, bytes_in: int = 1, bytes_acc: int = 2) -> int:
        """Count-weighted compulsory DRAM traffic [bytes] of one run.

        Each GEMM reads A (M*K) and B (K*N) once at ``bytes_in`` and
        writes its output (M*N) once at ``bytes_acc`` — the floor no
        SRAM capacity can beat; the engine's bandwidth model
        (``core.bandwidth``) converges to exactly this with unbounded
        per-tier SRAM.
        """
        return int(
            sum(
                g.count * ((g.M * g.K + g.K * g.N) * bytes_in
                           + g.M * g.N * bytes_acc)
                for g in self.gemms
            )
        )

    def arithmetic_intensity(self, bytes_in: int = 1, bytes_acc: int = 2) -> float:
        """MAC-ops per compulsory DRAM byte [ops/byte].

        The stream-level roofline knee: against a DRAM interface of
        ``B`` bytes/cycle, streams below ``B`` ops/byte per MAC are
        memory-bound even with perfect reuse — decode streams sit far
        below train/prefill ones (the bandwidth model's headline
        effect on the model zoo).
        """
        b = self.compulsory_bytes(bytes_in, bytes_acc)
        return self.total_macs / b if b else float("nan")


def _merge(arch: str, shape: str, mode: Mode, items) -> WorkloadStream:
    """Merge identical (M, K, N) shapes, keeping the first name."""
    by_shape: dict[tuple[int, int, int], list] = {}
    order: list[tuple[int, int, int]] = []
    for g in items:
        if g.count <= 0 or min(g.M, g.K, g.N) <= 0:
            continue
        key = (g.M, g.K, g.N)
        if key not in by_shape:
            by_shape[key] = [g.name, 0]
            order.append(key)
        by_shape[key][1] += g.count
    gemms = tuple(
        LayerGemm(name=by_shape[k][0], M=k[0], K=k[1], N=k[2], count=by_shape[k][1])
        for k in order
    )
    if not gemms:
        raise ValueError(f"{arch}/{shape}: lowering produced an empty stream")
    return WorkloadStream(arch=arch, shape=shape, mode=mode, gemms=gemms)


def _tokens(shape: ShapeConfig) -> tuple[int, int]:
    """(M dim per GEMM, per-network count multiplier) for the mode.

    train/prefill: the array streams one sequence at a time (M =
    seq_len); the global batch multiplies every count. decode: one
    batched decode step (M = global_batch) — the paper's small-M
    regime where the 3D/2D trade-off inverts.
    """
    if shape.mode == "decode":
        return shape.global_batch, 1
    return shape.seq_len, shape.global_batch


def _attention(cfg: ArchConfig, t: int, n_layers: int, prefix: str = ""):
    """q/k/v/o projection GEMMs for ``n_layers`` attention layers."""
    d, hd = cfg.d_model, cfg.head_dim_
    q_out = cfg.n_heads * hd
    kv_out = cfg.n_kv_heads * hd
    return [
        LayerGemm(f"{prefix}attn.q", t, d, q_out, n_layers),
        LayerGemm(f"{prefix}attn.kv", t, d, kv_out, 2 * n_layers),
        LayerGemm(f"{prefix}attn.o", t, q_out, d, n_layers),
    ]


def _mlp(cfg: ArchConfig, t: int, n_layers: int, d_ff: int | None = None,
         prefix: str = ""):
    """MLP GEMMs: gated (silu -> gate+up+down) or classic (up+down)."""
    d = cfg.d_model
    ff = cfg.d_ff if d_ff is None else d_ff
    if ff <= 0 or n_layers <= 0:
        return []
    n_in = 2 * n_layers if cfg.act == "silu" else n_layers
    return [
        LayerGemm(f"{prefix}mlp.in", t, d, ff, n_in),
        LayerGemm(f"{prefix}mlp.out", t, ff, d, n_layers),
    ]


def _logits(cfg: ArchConfig, t: int):
    return [LayerGemm("logits", t, cfg.d_model, cfg.vocab, 1)]


def _lower_dense(cfg: ArchConfig, t: int):
    return (
        _attention(cfg, t, cfg.n_layers)
        + _mlp(cfg, t, cfg.n_layers)
        + _logits(cfg, t)
    )


def _lower_moe(cfg: ArchConfig, t: int):
    """MoE: attention as dense; FFN = router + routed + shared experts.

    Routed expert GEMMs use the *expected* per-expert token count under
    uniform top-k routing, ceil(t * top_k / n_experts) — the quantity
    the paper's M dim sees per expert array pass.
    """
    d = cfg.d_model
    routed_t = max(1, -(-t * cfg.top_k // cfg.n_experts))
    ff = cfg.expert_d_ff
    out = _attention(cfg, t, cfg.n_layers)
    out.append(LayerGemm("moe.router", t, d, cfg.n_experts, cfg.n_layers))
    n_in = 2 if cfg.act == "silu" else 1
    out += [
        LayerGemm("moe.expert.in", routed_t, d, ff,
                  n_in * cfg.n_experts * cfg.n_layers),
        LayerGemm("moe.expert.out", routed_t, ff, d,
                  cfg.n_experts * cfg.n_layers),
    ]
    if cfg.n_shared_experts:
        out += [
            LayerGemm("moe.shared.in", t, d, ff,
                      n_in * cfg.n_shared_experts * cfg.n_layers),
            LayerGemm("moe.shared.out", t, ff, d,
                      cfg.n_shared_experts * cfg.n_layers),
        ]
    return out + _logits(cfg, t)


def _mamba_block(cfg: ArchConfig, t: int, n_layers: int):
    """Mamba2-style block: in_proj, depthwise conv (im2col), out_proj.

    The selective-scan recurrence itself is an outer-product state
    update (K = 1 per step) — not a GEMM — and is excluded; the paper's
    runtime model has nothing to say about it.
    """
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n_ssm_heads = max(1, d_in // cfg.ssm_head_dim)
    in_out = 2 * d_in + 2 * cfg.ssm_state + n_ssm_heads
    return [
        LayerGemm("ssm.in_proj", t, d, in_out, n_layers),
        # depthwise conv1d over the x/B/C streams as one im2col GEMM:
        # K = kernel taps, N = conv channels.
        LayerGemm("ssm.conv", t, CONV_WIDTH, d_in + 2 * cfg.ssm_state, n_layers),
        LayerGemm("ssm.out_proj", t, d_in, d, n_layers),
    ]


def _lower_ssm(cfg: ArchConfig, t: int):
    """SSM family: xLSTM-style blocks (q/k/v/o projections around the
    matrix-memory recurrence) when ``slstm_at``/``d_ff == 0`` says so,
    otherwise pure Mamba blocks."""
    if cfg.d_ff == 0:
        # xLSTM: 4 d x d projections per block (q/k/v + out); the
        # mLSTM recurrence is outer-product (K = 1), not lowered.
        d = cfg.d_model
        out = [
            LayerGemm("xlstm.qkv", t, d, d, 3 * cfg.n_layers),
            LayerGemm("xlstm.out", t, d, d, cfg.n_layers),
        ]
        return out + _logits(cfg, t)
    return _mamba_block(cfg, t, cfg.n_layers) + _logits(cfg, t)


def _lower_hybrid(cfg: ArchConfig, t: int):
    """Hybrid (zamba2): Mamba backbone + the weight-shared attention
    block applied after every ``attn_every``-th layer."""
    out = _mamba_block(cfg, t, cfg.n_layers)
    n_attn = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    if n_attn:
        out += _attention(cfg, t, n_attn, prefix="shared.")
        out += _mlp(cfg, t, n_attn, prefix="shared.")
    return out + _logits(cfg, t)


def _lower_encdec(cfg: ArchConfig, t: int, mode: Mode):
    """Encoder-decoder (whisper): encoder runs only when new frames are
    ingested (train/prefill); decode steps reuse the encoder output and
    the cross-attention k/v cache."""
    out = []
    if mode != "decode":
        et = cfg.enc_seq
        out += _attention(cfg, et, cfg.n_enc_layers, prefix="enc.")
        out += _mlp(cfg, et, cfg.n_enc_layers, prefix="enc.")
        # cross-attention k/v over encoder states, computed once
        kv_out = cfg.n_kv_heads * cfg.head_dim_
        out.append(
            LayerGemm("dec.cross.kv", et, cfg.d_model, kv_out, 2 * cfg.n_layers)
        )
    out += _attention(cfg, t, cfg.n_layers, prefix="dec.")
    # cross-attention q and o per decoder layer
    q_out = cfg.n_heads * cfg.head_dim_
    out += [
        LayerGemm("dec.cross.q", t, cfg.d_model, q_out, cfg.n_layers),
        LayerGemm("dec.cross.o", t, q_out, cfg.d_model, cfg.n_layers),
    ]
    out += _mlp(cfg, t, cfg.n_layers, prefix="dec.")
    return out + _logits(cfg, t)


def _lower_vlm(cfg: ArchConfig, t: int, mode: Mode):
    """VLM (llama-3.2-vision): dense self-attention layers plus
    cross-attention layers over precomputed image-patch embeddings.
    Image k/v are cached after prefill, so decode skips them."""
    n_cross = cfg.n_layers // cfg.cross_every if cfg.cross_every else 0
    n_self = cfg.n_layers - n_cross
    out = _attention(cfg, t, n_self)
    out += _mlp(cfg, t, cfg.n_layers)
    q_out = cfg.n_heads * cfg.head_dim_
    kv_out = cfg.n_kv_heads * cfg.head_dim_
    out += [
        LayerGemm("cross.q", t, cfg.d_model, q_out, n_cross),
        LayerGemm("cross.o", t, q_out, cfg.d_model, n_cross),
    ]
    if mode != "decode" and n_cross:
        out.append(
            LayerGemm("cross.kv", cfg.n_image_tokens, cfg.d_model, kv_out,
                      2 * n_cross)
        )
    return out + _logits(cfg, t)


_LOWERERS = {
    "dense": lambda cfg, t, mode: _lower_dense(cfg, t),
    "moe": lambda cfg, t, mode: _lower_moe(cfg, t),
    "ssm": lambda cfg, t, mode: _lower_ssm(cfg, t),
    "hybrid": lambda cfg, t, mode: _lower_hybrid(cfg, t),
    "encdec": _lower_encdec,
    "vlm": _lower_vlm,
}


def lower_network(cfg: ArchConfig, shape: ShapeConfig) -> WorkloadStream:
    """Lower one (arch, shape) cell to its GEMM workload stream."""
    if cfg.family not in _LOWERERS:
        raise ValueError(f"no lowerer for family {cfg.family!r} ({cfg.name})")
    t, mult = _tokens(shape)
    items = _LOWERERS[cfg.family](cfg, t, shape.mode)
    items = [dataclasses.replace(g, count=g.count * mult) for g in items]
    return _merge(cfg.name, shape.name, shape.mode, items)


def lower_zoo(shapes=None, archs=None) -> list[WorkloadStream]:
    """Lower every live (arch, shape) cell of the registry.

    ``shapes``/``archs`` filter by name; the arch-applicability rules
    of ``repro_torch.configs.cells`` apply (no full attention at 500k)."""
    from ..configs import REGISTRY, SHAPES, cells

    live, _ = cells()
    out = []
    for arch_name, shape_name in live:
        if shapes is not None and shape_name not in shapes:
            continue
        if archs is not None and arch_name not in archs:
            continue
        out.append(lower_network(REGISTRY[arch_name], SHAPES[shape_name]))
    return out
