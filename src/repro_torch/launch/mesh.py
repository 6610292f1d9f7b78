"""Meshes: the (data, model) grid of ranks the sharding rules map onto.

As in the JAX package, meshes are made by functions, never at import.
``make_test_mesh(data, model)`` lays the default process group out as a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")``, rank ``d * model + m`` at coordinate (d, m). At (1, 1) with
no process group it returns a one-rank ``MeshSpec``: the rules read only
axis names and sizes, and with every axis of size 1 the path issues no
collective. ``MeshSpec`` is also how the rules of a mesh that no process
group spans are built: ``make_production_mesh`` gives the reference's
(16, 16) and (2, 16, 16) shapes as such descriptions.
``make_stage_mesh(stages)`` is the pipeline's one-axis mesh, ``("pod",)``
as the reference's GPipe test makes it, in the same two forms.

``init_distributed(device)`` joins the process group of the device's
backend (``gloo`` on the CPU, ``nccl`` on ``cuda``, never chosen from
``torch.cuda.is_available()``); under ``torchrun`` it reads ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``, and each rank takes
``cuda:{LOCAL_RANK}``.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["MeshSpec", "axis_names", "axis_sizes", "make_production_mesh", "make_test_mesh",
           "make_stage_mesh", "init_distributed", "mesh_size", "cli_mesh", "is_first_rank"]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis sizes and names, with no ranks behind it."""

    sizes: tuple
    names: tuple

    def __post_init__(self):
        if len(self.sizes) != len(self.names):
            raise ValueError(f"mesh sizes {self.sizes} and names {self.names} differ in rank")


def axis_names(mesh) -> tuple:
    return tuple(mesh.names) if isinstance(mesh, MeshSpec) else tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``MeshSpec`` or a ``DeviceMesh``."""
    sizes = mesh.sizes if isinstance(mesh, MeshSpec) else tuple(mesh.shape)
    return dict(zip(axis_names(mesh), sizes))


def mesh_size(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """Single pod: 16 x 16 = 256 ranks (data, model). Multi-pod: 2 pods,
    512 ranks (pod, data, model)."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))


_MESHES: dict = {}  # the default group's meshes by shape: one set of subgroups each


def make_test_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh over the default process group, or a one-rank
    ``MeshSpec`` at (1, 1) when no group is initialised. One default group
    gives one mesh of each shape, made on the first call (its subgroups
    are collective to make: every rank asks for the same shapes in the
    same order)."""
    return _mesh((data, model), ("data", "model"))


def make_stage_mesh(stages: int = 1):
    """The pipeline's one-axis mesh of ``stages`` ranks, ``("pod",)``, over
    the default process group, or a one-rank ``MeshSpec`` for one stage
    when no group is initialised."""
    return _mesh((stages,), ("pod",))


def _mesh(shape: tuple, names: tuple):
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(f"a {shape} mesh needs a process group of {math.prod(shape)} "
                               "ranks; none is initialised (init_distributed)")
        return MeshSpec(shape, names)
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the process "
                         f"group has {world}")
    from torch.distributed.device_mesh import DeviceMesh

    if _MESHES.get("world") is not dist.group.WORLD:  # a new default group
        _MESHES.clear()
        _MESHES["world"] = dist.group.WORLD
    if (shape, names) not in _MESHES:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        _MESHES[shape, names] = DeviceMesh(device_type, torch.arange(world).reshape(shape),
                                           mesh_dim_names=names)
    return _MESHES[shape, names]


def init_distributed(device=None, *, init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None) -> torch.device:
    """Join the default process group for ``device`` (``cuda`` unless
    ``"cpu"``) and return this rank's device. ``rank`` and ``world_size``
    default to ``torchrun``'s ``RANK`` and ``WORLD_SIZE``; ``init_method``
    to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``)."""
    dev = resolve_device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method or "env://", rank=rank,
                                world_size=world_size)
    return dev


def cli_mesh(device=None):
    """``(device, mesh_shape)`` of a launcher's CLI: one rank at (1, 1),
    or under ``torchrun`` (``WORLD_SIZE`` > 1) this rank's device in the
    process group of the world, laid out as a (1, WORLD_SIZE) mesh."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world == 1:
        return resolve_device(device), (1, 1)
    return init_distributed(device), (1, world)


def is_first_rank() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
