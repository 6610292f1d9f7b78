"""Plain PyTorch versions of the dOS matmul (the kernel's oracles).

``matmul_ref`` is the plain GEMM with f32 accumulation that the wrapper
runs for CPU tensors and that ``chip_smoke.py`` holds the CUDA kernel
against. ``dos_matmul_ref`` reproduces the tier-split accumulation
order: K is cut into ``n_tiers`` contiguous slices, each slice gives an
f32 partial sum, and the partial sums are added in order down the pile
(paper Fig. 3).
"""

from __future__ import annotations

import torch

__all__ = ["matmul_ref", "dos_matmul_ref"]


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``a(..., K) @ b(K, N)`` summed in f32, cast to ``out_dtype``."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def dos_matmul_ref(a: torch.Tensor, b: torch.Tensor, n_tiers: int = 1, out_dtype=None):
    """Tier-split ``a(M, K) @ b(K, N)`` with the kernel's accumulation order."""
    out_dtype = out_dtype or a.dtype
    k = a.shape[-1]
    if b.shape[0] != k:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ {tuple(b.shape)}")
    if k % n_tiers:
        raise ValueError(f"K={k} must divide into {n_tiers} tiers")
    kl = k // n_tiers
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for t in range(n_tiers):  # sequential adder pile
        sl = slice(t * kl, (t + 1) * kl)
        acc = acc + a[:, sl].float() @ b[sl, :].float()
    return acc.to(out_dtype)
