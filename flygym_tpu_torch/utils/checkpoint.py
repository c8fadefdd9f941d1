"""Simulation state checkpoints.

Port of ``flygym_tpu/utils/checkpoint.py``: the full dynamic
:class:`~flygym_tpu_torch.engine.model.State`, one world or a batch, to and
from a compressed npz file. The file holds one array per field under the
JAX package's names (``_FIELDS``), so a file written by either package
loads in the other. ``put_like`` (a loaded state onto a mesh's shardings)
waits for the port's multi-card runtime.
"""

from os import PathLike
from pathlib import Path

import numpy as np
import torch

from flygym_tpu_torch.engine.model import State
from flygym_tpu_torch.ops import checked_device

__all__ = ["save_state", "load_state"]

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
