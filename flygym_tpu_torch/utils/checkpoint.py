"""Simulation state checkpoints.

Port of ``flygym_tpu/utils/checkpoint.py``: the full dynamic
:class:`~flygym_tpu_torch.engine.model.State`, one world or a batch, to and
from a compressed npz file. The file holds one array per field under the
JAX package's names (``_FIELDS``), so a file written by either package
loads in the other. :func:`put_like` puts a loaded state onto the devices
of a live state split over a mesh.
"""

from os import PathLike
from pathlib import Path

import numpy as np
import torch

from flygym_tpu_torch.engine.model import State
from flygym_tpu_torch.ops import checked_device
from flygym_tpu_torch.parallel.mesh import WorldMesh, shard_world_axis

__all__ = ["save_state", "load_state", "put_like"]

_FIELDS = (
    "qpos",
    "qvel",
    "ctrl",
    "act",
    "time",
    "qacc",
    "xpos",
    "xquat",
    "site_xpos",
    "actuator_force",
    "contact_sensordata",
)


def save_state(state: State, path: PathLike) -> None:
    """Write ``state`` (its fields as they are, batched or not) to a
    compressed npz file, making its directory if need be."""
    arrays = {name: getattr(state, name).detach().cpu().numpy() for name in _FIELDS}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_state(path: PathLike, device="cuda") -> State:
    """A State written by :func:`save_state` (or by the JAX package's), on
    ``device``: the card by default; pass ``"cpu"`` for the CPU."""
    device = checked_device(device)
    with np.load(Path(path), allow_pickle=False) as data:
        return State(**{name: torch.from_numpy(data[name]).to(device) for name in _FIELDS})


def put_like(state: State, reference):
    """``state`` placed as ``reference`` is placed (``flygym_tpu/utils/
    checkpoint.py:51-56``): for a list of per-shard States (a state split
    over a mesh, :func:`~flygym_tpu_torch.parallel.shard_world_axis`) split
    over the shards' devices in blocks as theirs; for a State, on that
    State's device."""
    if isinstance(reference, State):
        return state.to(reference.qpos.device)
    n = sum(r.qpos.shape[0] for r in reference)
    if state.qpos.shape[0] != n:
        raise ValueError(f"a state of {state.qpos.shape[0]} worlds does not fit shards of "
                         f"{n} worlds")
    return shard_world_axis(state, WorldMesh(tuple(r.qpos.device for r in reference)))
