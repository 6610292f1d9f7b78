"""Cycle-level functional simulator of the paper's 2D/3D systolic arrays.

This is the executable form of the paper's Figs. 1-4: it simulates the
output-stationary (OS) dataflow on a 2D R x C MAC array cycle by cycle,
and the distributed-output-stationary (dOS) dataflow on an l-tier 3D
array (per-tier OS on a K/l slice + sequential partial-sum accumulation
down the tier pile). It serves two purposes:

1. **Correctness of the dataflow**: the simulated array must produce
   exactly ``A @ B`` (property-tested over random shapes).
2. **Validation of the analytical model**: the simulated cycle counts
   must equal Eq. 1 / Eq. 2 of ``core.analytical`` exactly.

The simulation itself is torch (a Python loop over cycles), on the card
unless the caller names another device; the folds and tiers are batch
dimensions of one tensor — i.e. we simulate the 3D array the same way
the hardware would run it: all tiers in lockstep, then the (l-1)-add
accumulation.

Mechanics of one OS tile (r, c are PE coordinates):
  - A enters column 0 skewed by row:   PE(r, 0) receives A[r, t-r] at cycle t
  - B enters row 0 skewed by column:   PE(0, c) receives B[t-c, c] at cycle t
  - per cycle: operands shift right/down one PE; each PE multiplies its
    current pair and accumulates locally.
  - PE(r, c) therefore sees (A[r, k], B[k, c]) together at cycle r+c+k,
    accumulating the exact dot product. Compute finishes at cycle
    R+C+K-2; draining the outputs costs another R cycles, giving
    Eq. 1's per-fold term (2R + C + K - 2).
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from .analytical import tau_2d, tau_3d

__all__ = ["SimResult", "simulate_os_2d", "simulate_dos_3d"]


@dataclasses.dataclass
class SimResult:
    out: torch.Tensor  # the computed M x N product
    cycles: int  # simulated runtime in cycles (incl. fill + drain + reduce)
    folds: int  # number of serialization steps
    tiers: int


def _injection_schedules(A_tile, B_tile, R, C, K):
    """Skewed operand injection over leading batch dims:
    Ainj[..., t, r] = A[..., r, t-r], Binj[..., t, c] = B[..., t-c, c]."""
    dev = A_tile.device
    T = R + C + K - 2  # last useful cycle index is (R-1)+(C-1)+(K-1)
    t = torch.arange(T, device=dev)[:, None]
    r = torch.arange(R, device=dev)[None, :]
    c = torch.arange(C, device=dev)[None, :]
    ka = t - r  # (T, R) index into K for A
    kb = t - c  # (T, C) index into K for B
    a_valid = (ka >= 0) & (ka < K)
    b_valid = (kb >= 0) & (kb < K)
    Ainj = torch.where(a_valid, A_tile[..., r, ka.clamp(0, K - 1)], 0.0)
    Binj = torch.where(b_valid, B_tile[..., kb.clamp(0, K - 1), c], 0.0)
    return Ainj, Binj, T


def _simulate_tile(A_tile, B_tile, R: int, C: int):
    """Simulate OS folds on an R x C array, one per batch element.
    A_tile: (..., R, K), B_tile: (..., K, C); their batch dims broadcast."""
    K = A_tile.shape[-1]
    Ainj, Binj, T = _injection_schedules(A_tile, B_tile, R, C, K)
    a_reg = torch.zeros(A_tile.shape[:-2] + (R, C), dtype=A_tile.dtype, device=A_tile.device)
    b_reg = torch.zeros(B_tile.shape[:-2] + (R, C), dtype=B_tile.dtype, device=B_tile.device)
    acc = torch.zeros(torch.broadcast_shapes(a_reg.shape, b_reg.shape), dtype=A_tile.dtype,
                      device=A_tile.device)
    for t in range(T):
        # operands march right / down by one PE per cycle
        a_reg = torch.cat([Ainj[..., t, :, None], a_reg[..., :, :-1]], dim=-1)
        b_reg = torch.cat([Binj[..., t, None, :], b_reg[..., :-1, :]], dim=-2)
        acc = acc + a_reg * b_reg
    return acc


def _operands(A, B, device):
    dev = resolve_device(device)
    return (torch.as_tensor(A, dtype=torch.float32).to(dev),
            torch.as_tensor(B, dtype=torch.float32).to(dev))


def simulate_os_2d(A, B, R: int, C: int, device=None) -> SimResult:
    """OS dataflow on a 2D R x C array, with M/N fold serialization.

    Simulated cycles match Eq. 1: (2R + C + K - 2) * ceil(M/R) * ceil(N/C).
    ``device``: ``None`` means the card.
    """
    A, B = _operands(A, B, device)
    M, K = A.shape
    K2, N = B.shape
    if K != K2:
        raise ValueError(f"inner dims differ: {tuple(A.shape)} @ {tuple(B.shape)}")
    m_folds = -(-M // R)
    n_folds = -(-N // C)
    # Pad to full fold tiles; ragged edges are computed with zero padding
    # (hardware would gate those PEs off; runtime is unchanged).
    Ap = torch.nn.functional.pad(A, (0, 0, 0, m_folds * R - M))
    Bp = torch.nn.functional.pad(B, (0, n_folds * C - N))
    A_tiles = Ap.reshape(m_folds, 1, R, K)
    B_tiles = Bp.reshape(K, n_folds, C).permute(1, 0, 2)[None]
    # fold tiles as batch dims = serial steps in hardware, identical math.
    tiles = _simulate_tile(A_tiles, B_tiles, R, C)  # (m_folds, n_folds, R, C)
    out = tiles.permute(0, 2, 1, 3).reshape(m_folds * R, n_folds * C)[:M, :N]
    cycles = int(tau_2d(M, K, N, R, C))
    return SimResult(out=out, cycles=cycles, folds=m_folds * n_folds, tiers=1)


def simulate_dos_3d(A, B, R: int, C: int, tiers: int, device=None) -> SimResult:
    """dOS dataflow on an l-tier 3D array of R x C tiles (paper Figs. 3-4).

    K is split into ceil(K/l) slices; every tier runs OS on its slice in
    lockstep (a batch dim); then each output pile accumulates its l
    partial sums with l-1 sequential cross-tier adds (the TSV/MIV
    traffic). Simulated cycles match Eq. 2. ``device``: ``None`` means
    the card.
    """
    A, B = _operands(A, B, device)
    M, K = A.shape
    _, N = B.shape
    L = int(tiers)
    kl = -(-K // L)
    # Pad K so every tier gets a full slice (zeros contribute nothing).
    Ap = torch.nn.functional.pad(A, (0, kl * L - K))
    Bp = torch.nn.functional.pad(B, (0, 0, 0, kl * L - K))
    A_sl = Ap.reshape(M, L, kl).permute(1, 0, 2)  # (L, M, kl)
    B_sl = Bp.reshape(L, kl, N)  # (L, kl, N)

    m_folds = -(-M // R)
    n_folds = -(-N // C)
    Apad = torch.nn.functional.pad(A_sl, (0, 0, 0, m_folds * R - M))
    Bpad = torch.nn.functional.pad(B_sl, (0, n_folds * C - N))
    A_tiles = Apad.reshape(L, m_folds, R, kl).permute(1, 0, 2, 3)[:, None]  # (mf, 1, L, R, kl)
    B_tiles = Bpad.reshape(L, kl, n_folds, C).permute(2, 0, 1, 3)[None]  # (1, nf, L, kl, C)
    partial = _simulate_tile(A_tiles, B_tiles, R, C)  # (m_folds, n_folds, L, R, C)

    # Cross-tier accumulation pile: l-1 strictly sequential adds, exactly
    # as the partial sums ripple down the TSV/MIV pile to the bottom tier.
    acc = partial[:, :, 0]
    for tier in range(1, L):
        acc = acc + partial[:, :, tier]
    out = acc.permute(0, 2, 1, 3).reshape(m_folds * R, n_folds * C)[:M, :N]
    cycles = int(tau_3d(M, K, N, R, C, L))
    return SimResult(out=out, cycles=cycles, folds=m_folds * n_folds, tiers=L)
