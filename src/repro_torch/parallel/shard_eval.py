"""Device-sharded dispatch of the batched (R, C) design-space search.

The engine's hot kernel (``core.analytical._search_rc_torch``) is
rowwise independent: every design point's search reads only its own
(D1, D2, Tser, budget) row. So data-parallel execution across devices is
exact: this module splits the flat point batch into ``n_shards`` equal
parts, runs the *same* search on each part on its device, and stitches
the results back, bit for bit the unsharded search's (the reference
pins the same with ``tests/test_scale.py``). The reference shards over
the host's JAX devices with ``shard_map``; here the shards go to the
local devices of the search's device type (each CUDA card; on the CPU
there is one).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_shards", "local_devices", "sharded_search"]


def local_devices(device: torch.device) -> list:
    """The local devices of ``device``'s type: every CUDA card, or the CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)]


def resolve_shards(shard, device: torch.device) -> int:
    """Normalize an ``evaluate(shard=...)`` request to a shard count.

    ``None``/``'none'``/``1`` -> 1 (unsharded). ``'auto'`` -> the number
    of local devices of the search's device type. An explicit int must
    not exceed that count (one sub-batch per device)."""
    if shard is None or shard == "none" or shard == 1:
        return 1
    n_dev = len(local_devices(device))
    if shard == "auto":
        return n_dev
    try:
        n = int(shard)
    except (TypeError, ValueError):
        raise ValueError(
            f"shard must be None, 'none', 'auto' or a positive int, got {shard!r}"
        ) from None
    if n < 1:
        raise ValueError(f"shard must be >= 1, got {n}")
    if n > n_dev:
        raise ValueError(f"shard={n} exceeds the {n_dev} local {device.type} device(s)")
    return n


def sharded_search(D1, D2, Tser, budget, r_max_total: int, n_shards: int, devices):
    """One search batch split across ``n_shards`` shards, shard ``i`` on
    ``devices[i]``. Inputs are (B,) int64 numpy arrays; B need not divide
    the shard count: the batch is padded with trivial rows (all-ones
    searches) and sliced back, so degenerate batches (B < n_shards,
    B == 1) are exact. Returns (r, c, tau) int64 numpy arrays."""
    from ..core.analytical import _search_rc_torch

    B = D1.shape[0]
    pad = (-B) % n_shards
    if pad:
        one = np.ones(pad, dtype=np.int64)
        D1, D2, Tser, budget = (np.concatenate([a, one]) for a in (D1, D2, Tser, budget))
    per = D1.shape[0] // n_shards
    parts = []
    for i in range(n_shards):  # each device's search is enqueued before any result is read
        args = [torch.from_numpy(np.ascontiguousarray(a[i * per:(i + 1) * per])).to(devices[i])
                for a in (D1, D2, Tser, budget)]
        parts.append(_search_rc_torch(*args, r_max_total))
    return tuple(torch.cat([p[j].cpu() for p in parts]).numpy()[:B] for j in range(3))
