"""Worlds split over a 1-D mesh of devices.

Port of ``flygym_tpu/parallel/mesh.py``. The workload has one axis of
parallelism, the independent worlds, and the physics step has no operation
across worlds, so a mesh needs no collective: each device steps its own
block of worlds. Where the JAX package shards one global array with
``NamedSharding(mesh, P("world"))``, the port keeps one tensor, or one
:class:`~flygym_tpu_torch.engine.model.State`, per shard: contiguous equal
blocks of the world axis, block i on the mesh's device i. The model is
copied once to each distinct device.

A device may appear more than once in a mesh. Two shards on ``cuda:0`` run
the sharded program on one card, as the JAX package's tests run theirs on
virtual CPU devices.

Usage::

    mesh = make_world_mesh()                        # every visible card
    sim = BatchSimulation(world, 8192, mesh=mesh)   # worlds split over them
"""

from dataclasses import dataclass, fields

import torch

from flygym_tpu_torch.ops import checked_device

__all__ = ["WorldMesh", "canonical_device", "gather_world_axis", "make_world_mesh", "replicate_model",
           "shard_world_axis"]


@dataclass(frozen=True)
class WorldMesh:
    """A 1-D mesh: the devices of the shards in order, and the axis name."""

    devices: tuple
    axis_name: str = "world"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_world_mesh(devices=None, axis_name: str = "world") -> WorldMesh:
    """A 1-D mesh over ``devices`` (devices, their names or card indices);
    None takes every visible card, and raises where there is none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=['cpu', ...] to "
                               "split worlds on the CPU")
        devices = range(torch.cuda.device_count())
    devices = tuple(canonical_device(checked_device(f"cuda:{d}" if isinstance(d, int) else d))
                    for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return WorldMesh(devices, axis_name)


def canonical_device(device: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:i``, as a tensor's device reads."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _blocks(n: int, mesh: WorldMesh) -> int:
    if n % mesh.size:
        raise ValueError(f"n_worlds={n} not divisible by mesh axis '{mesh.axis_name}' of size "
                         f"{mesh.size}")
    return n // mesh.size


def shard_world_axis(tree, mesh: WorldMesh, dim: int = 0) -> list:
    """A world-batched tensor or State split into ``mesh.size`` contiguous
    equal blocks of its world axis ``dim``, block i on ``mesh.devices[i]``
    (what ``NamedSharding(mesh, P("world"))`` gives, ``dim`` 1 what
    ``P(None, "world")`` gives). A mesh of one device takes the whole of
    ``tree``, moved there."""
    if mesh.size == 1:
        return [tree.to(mesh.devices[0])]
    if isinstance(tree, torch.Tensor):
        b = _blocks(tree.shape[dim], mesh)
        return [tree.narrow(dim, i * b, b).to(d) for i, d in enumerate(mesh.devices)]
    b = _blocks(tree.qpos.shape[dim], mesh)
    return [tree.map(lambda x, i=i, d=d: x.narrow(dim, i * b, b).to(d))
            for i, d in enumerate(mesh.devices)]


def gather_world_axis(shards: list, dim: int = 0):
    """The shards of :func:`shard_world_axis` joined on ``dim``, on the
    first shard's device; one shard is returned as it is."""
    if len(shards) == 1:
        return shards[0]
    if isinstance(shards[0], torch.Tensor):
        return torch.cat([s.to(shards[0].device) for s in shards], dim=dim)
    dev = shards[0].qpos.device
    return type(shards[0])(**{f.name: torch.cat([getattr(s, f.name).to(dev) for s in shards],
                                                dim=dim) for f in fields(shards[0])})


def replicate_model(model, mesh: WorldMesh) -> list:
    """The model on every shard's device: one copy per distinct device, the
    same copy for shards that share a device."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = model.to(d)
    return [copies[d] for d in mesh.devices]
