"""The reference's own reading of a configuration's world file.

A world is an ``.npz`` file exported from a compiled model: ``meta`` (JSON:
the model's static fields, the flies' index maps, the env's tables) and
arrays ``model.<field>`` and ``state.<field>``. The reference reads them
here with numpy, as the port's loader reads them (float arrays as float32,
integer arrays as int64), into a plain namespace that
:class:`portbench.reference.emitter._Static` reads, and a one-world
:class:`State`. Nothing of the port is imported.
"""

import json
from dataclasses import dataclass, fields
from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["ActKind", "State", "load_world"]


class ActKind:
    """Integer codes for actuator kinds (the port's and the JAX package's)."""

    MOTOR = 0
    POSITION = 1
    VELOCITY = 2
    INTVELOCITY = 3
    DAMPER = 4
    ADHESION = 5
    CYLINDER = 6
    MUSCLE = 7


@dataclass(frozen=True)
class State:
    """A batch of worlds' state, batch-first, with the port's field names."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    ctrl: torch.Tensor
    act: torch.Tensor
    time: torch.Tensor
    qacc: torch.Tensor
    xpos: torch.Tensor
    xquat: torch.Tensor
    site_xpos: torch.Tensor
    actuator_force: torch.Tensor
    contact_sensordata: torch.Tensor

    @classmethod
    def of(cls, other) -> "State":
        """The fields of another state object with these names (the port's)."""
        return cls(**{f.name: getattr(other, f.name) for f in fields(cls)})

    def map(self, fn) -> "State":
        return State(**{f.name: fn(getattr(self, f.name)) for f in fields(self)})

    def to(self, device) -> "State":
        return self.map(lambda x: x.to(device))


def _array(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.astype(np.float32)
    if a.dtype.kind in "iu":
        return a.astype(np.int64)
    if a.dtype.kind == "b":
        return a
    raise TypeError(f"unsupported array dtype {a.dtype}")


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def load_world(path):
    """``(model, state, meta)`` of an exported world: the model as a
    namespace of numpy arrays and static fields, its one-world initial
    state (B = 1, CPU float32 tensors), and the JSON metadata."""
    with np.load(path, allow_pickle=False) as npz:
        meta = json.loads(str(npz["meta"]))
        arrays = {k: npz[k] for k in npz.files if k != "meta"}
    kw = {k[len("model."):]: _array(v) for k, v in arrays.items() if k.startswith("model.")}
    kw.update({k: _tuples(v) for k, v in meta["model"].items()})
    model = SimpleNamespace(**kw)
    state = State(**{f.name: torch.from_numpy(_array(arrays[f"state.{f.name}"]))[None]
                     for f in fields(State)})
    return model, state, meta
