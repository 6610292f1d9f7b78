"""int8 + error-feedback gradient all-reduce, the counterpart of the JAX
package's ``parallel/compression.py``.

Cross-replica gradient sync is the data-parallel analogue of the paper's
cross-tier partial-sum pile. Each rank quantizes its local gradient to
int8 with a per-tensor scale, the int8 values are summed over the data
axis (in int32: no overflow), dequantized with the mean of the ranks'
scales, and the rank's quantization residual is kept as error-feedback
state added to the next step's gradient (EF-SGD). Leaf by leaf, as the
reference. The reference's approximation is kept: every rank's sum is
dequantized with the mean scale, not each rank's own.

The arithmetic is the reference's as XLA's compile of it rounds: the
scale ``max|g| / 127 + 1e-12`` and the residual ``g - q * scale`` each
with one rounding (XLA fuses them into multiply-adds; here they are
formed exactly in f64 and rounded once to f32), ``g / scale`` rounded
half to even, the sums in order. So a rank's ``q``, ``g_hat`` and
``new_err`` are the same bits on the card and on the CPU. Params must be
replicated over ``axis`` (the reference's trade-off: this composes with
model sharding, not with ZeRO).
"""

from __future__ import annotations

import torch

from ..models.params import leaves, unflatten
from . import collectives as C

__all__ = ["compressed_psum_grads", "init_error_state", "quantize"]


def init_error_state(params):
    """Zero residuals in f32, one per parameter leaf."""
    return unflatten((path, torch.zeros(p.shape, dtype=torch.float32, device=p.device))
                     for path, p in leaves(params))


def quantize(x):
    """``(q, scale)``: int8 ``clip(round(x / scale), -127, 127)`` and the
    f32 per-tensor scale ``max|x| / 127 + 1e-12`` (one rounding)."""
    recip = torch.tensor(1.0, dtype=torch.float32) / 127.0  # the f32 reciprocal XLA multiplies by
    eps = torch.tensor(1e-12, dtype=torch.float32)
    scale = (x.abs().max().double() * recip.double().item() + eps.double().item()).float()
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_grads(grads, error_state, mesh, axis: str = "data"):
    """All-reduce ``grads`` over ``axis`` in int8 with error feedback.
    Returns ``(synced_grads_f32, new_error_state)``; call it on each rank's
    local (per-replica mean) gradients."""
    n = C.axis_size(mesh, axis)

    def one_sync(g, err):
        g = g.float() + err
        q, scale = quantize(g)
        qsum = C.psum(q.to(torch.int32), mesh, axis)
        ssum = C.psum(scale, mesh, axis)
        n_t = torch.full((), float(n), dtype=torch.float32, device=g.device)
        g_hat = qsum.float() * (ssum / n_t) / n_t
        new_err = (g.double() - q.double() * scale.double()).float()  # the local residual
        return g_hat, new_err

    errs = dict(leaves(error_state))
    out_g, out_e = [], []
    for path, g in leaves(grads):
        g_hat, new_err = one_sync(g, errs[path])
        out_g.append((path, g_hat))
        out_e.append((path, new_err))
    return unflatten(out_g), unflatten(out_e)
