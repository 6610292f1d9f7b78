"""Plain PyTorch versions of the grouped GEMM and its gradients.

The experts' product of a Mixture-of-Experts FFN, the reference's
``jax.lax.ragged_dot``: with the rows of x sorted by group, group g owns
rows ``[off_g, off_g + size_g)`` (off_g the sum of the sizes before it),

    out[r] = x[r] @ w[g]       for r in group g; rows past the sum are 0

summed in f32 and returned in x's type. Its gradients in closed form:
dx is the same product on ``w.transpose(-1, -2)`` (``grouped_matmul_ref``
again) and dw[g] = x[rows of g]^T dy[rows of g] summed in f32 and cast
to the dtype asked for (``grouped_matmul_dw_ref``; an empty group's is
zero). Sizes are
clamped to the rows there are. Each is a loop over the groups; the
sizes are read on the host.
"""

from __future__ import annotations

import torch

__all__ = ["group_bounds", "grouped_matmul_dw_ref", "grouped_matmul_ref"]


def group_bounds(group_sizes, rows: int) -> list[tuple[int, int]]:
    """Each group's rows ``(first, end)``, the sizes clamped to ``rows``."""
    out, off = [], 0
    for size in torch.as_tensor(group_sizes).tolist():
        a = min(off, rows)
        off += max(int(size), 0)
        out.append((a, min(off, rows)))
    return out


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor, group_sizes) -> torch.Tensor:
    """x (R, K), w (G, K, N), group_sizes (G,) -> (R, N) in x's dtype."""
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32, device=x.device)
    for g, (a, b) in enumerate(group_bounds(group_sizes, x.shape[0])):
        if b > a:
            out[a:b] = x[a:b].float() @ w[g].float()
    return out.to(x.dtype)


def grouped_matmul_dw_ref(x: torch.Tensor, dy: torch.Tensor, group_sizes,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (R, K), dy (R, N), group_sizes (G,) -> dw (G, K, N), summed in f32
    and cast to ``out_dtype``."""
    bounds = group_bounds(group_sizes, x.shape[0])
    dw = torch.zeros((len(bounds), x.shape[1], dy.shape[1]), dtype=torch.float32,
                     device=x.device)
    for g, (a, b) in enumerate(bounds):
        if b > a:
            dw[g] = x[a:b].float().T @ dy[a:b].float()
    return dw.to(out_dtype)
