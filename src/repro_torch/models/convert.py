"""Weight bridge: the JAX package's parameter tree -> the port's.

The reference's tree crosses as nested dicts (and, for the xLSTM's
``blocks``, lists) of numpy arrays (a test exports it with
``jax.tree.map(np.asarray, params)``) in its stacked layer layout:
``layers.attn.wq`` is (L, E, H*hd), and so on. The port
keeps that layout, so the bridge checks every leaf against the model's
ParamDef tree (same keys, same shapes) and moves it to the model's
device. It reads numpy only. ``opt_state_from_numpy`` carries the
optimizer state ``{"m", "v", "step"}`` across the same way, so that a
test can start both packages' training from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import leaves, unflatten

__all__ = ["from_numpy", "opt_state_from_numpy"]


def from_numpy(model, tree, dtype=None):
    """Port parameters for ``model`` from a nested dict of numpy arrays."""
    want = dict(leaves(model.defs))
    have = dict(leaves(tree))
    if want.keys() != have.keys():
        missing = sorted(map(str, want.keys() - have.keys()))
        extra = sorted(map(str, have.keys() - want.keys()))
        raise ValueError(f"parameter trees differ: missing {missing}, unexpected {extra}")
    for path, d in want.items():
        if np.shape(have[path]) != tuple(d.shape):
            raise ValueError(
                f"{'.'.join(map(str, path))}: shape {np.shape(have[path])}, want {d.shape}"
            )

    def one(a):
        t = torch.tensor(np.asarray(a))  # a copy: exported arrays are read-only
        return t.to(device=model.device, dtype=dtype or t.dtype)

    return unflatten((path, one(have[path])) for path in want)


def opt_state_from_numpy(model, state):
    """The reference's AdamW state ``{"m", "v", "step"}`` (numpy leaves)
    for ``model``: the moments as parameter trees, ``step`` a 0-d int32."""
    return {
        "m": from_numpy(model, state["m"]),
        "v": from_numpy(model, state["v"]),
        "step": torch.tensor(np.asarray(state["step"]), dtype=torch.int32, device=model.device),
    }
