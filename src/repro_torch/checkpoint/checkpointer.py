"""Checkpointing with async writes, in the JAX package's exact layout.

Layout: ``<dir>/step_<N>/`` holding one ``.npy`` per leaf plus
``meta.json`` (step and the sorted leaf names). A leaf's name is its
path joined by ``__``: dict keys, visited in sorted order as
``jax.tree_util.tree_flatten_with_path`` visits them, and list entries
by index (``opt__m__embed__tok``, ``opt__step``). So a checkpoint that
either package writes restores in the other. The write goes to
``step_<N>.tmp`` and is renamed when complete; the ``keep`` newest steps
are retained. ``save_async`` copies the tensors to the host now and
writes them on a background thread while training goes on.

Leaves are f32, int32 or any dtype numpy has; a bf16 leaf raises (numpy
has no bf16 without ``ml_dtypes``; the training state is f32 and int32).
``restore`` returns numpy arrays in the structure of ``like``; the
caller moves them to a device.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading

import numpy as np
import torch

__all__ = ["save", "save_async", "restore", "latest_step", "wait_for_saves"]

_FLAT_SEP = "__"
_pending: list[threading.Thread] = []


def _flatten(tree, path=()):
    """{name: leaf} in the reference's order (sorted dict keys, list
    indices)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, x in enumerate(tree):
            out.update(_flatten(x, path + (str(i),)))
        return out
    return {_FLAT_SEP.join(path): tree}


def _unflatten_like(like, arrays, path=()):
    if isinstance(like, dict):
        return {k: _unflatten_like(like[k], arrays, path + (str(k),)) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(x, arrays, path + (str(i),)) for i, x in enumerate(like))
    return arrays[_FLAT_SEP.join(path)]


def _to_host(tree):
    """Numpy copies of every leaf (tensors leave the device here)."""
    def one(x):
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.bfloat16:
                raise TypeError("checkpoint leaves must be f32, int32 or another numpy "
                                "dtype; got a bfloat16 tensor")
            return x.detach().cpu().numpy().copy()
        return np.array(x)

    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return one(tree)


def save(ckpt_dir, step: int, tree, keep: int = 3):
    """Synchronous checkpoint write."""
    _write(pathlib.Path(ckpt_dir), step, _to_host(tree), keep)


def save_async(ckpt_dir, step: int, tree, keep: int = 3):
    """Device->host copy happens now; disk I/O on a background thread."""
    host_tree = _to_host(tree)
    t = threading.Thread(
        target=_write, args=(pathlib.Path(ckpt_dir), step, host_tree, keep),
        daemon=True,
    )
    t.start()
    _pending.append(t)
    return t


def wait_for_saves():
    for t in _pending:
        t.join()
    _pending.clear()


def _write(root: pathlib.Path, step: int, host_tree, keep: int):
    flat = _flatten(host_tree)
    tmp = root / f"step_{step}.tmp"
    final = root / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    for key, leaf in flat.items():
        np.save(tmp / f"{key}.npy", leaf)
    (tmp / "meta.json").write_text(json.dumps({"step": step, "keys": sorted(flat)}))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic completion marker
    # retention
    steps = sorted(
        int(p.name.split("_")[1]) for p in root.glob("step_*") if p.is_dir()
        and not p.name.endswith(".tmp")
    )
    for s in steps[:-keep]:
        shutil.rmtree(root / f"step_{s}", ignore_errors=True)


def latest_step(ckpt_dir) -> int | None:
    root = pathlib.Path(ckpt_dir)
    if not root.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in root.glob("step_*")
        if p.is_dir() and (p / "meta.json").exists()
    ]
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, like):
    """Load into the structure of ``like`` (a tree of tensors or arrays).
    Returns a tree of numpy arrays."""
    root = pathlib.Path(ckpt_dir) / f"step_{step}"
    arrays = {key: np.load(root / f"{key}.npy") for key in _flatten(like)}
    return _unflatten_like(like, arrays)
