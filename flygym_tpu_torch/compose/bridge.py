"""The bridge from a compiled JAX model, exported as numpy, to the port.

The JAX package compiles a composed ``World`` into its ``PhysicsModel``
(``flygym_tpu/compose/spec.py:907-1046``), which needs JAX. The port takes
that compiled model as data instead: ``scripts/export_torch_model.py``
writes every array field, the static fields, the initial state and the
fly's index maps to an ``.npz`` file, and :func:`model_from_numpy` turns
them into the port's :class:`~flygym_tpu_torch.engine.model.PhysicsModel`.

Models that use a feature the port does not have yet are refused here,
with ``NotImplementedError``, rather than simulated wrongly.
"""

import json
from dataclasses import dataclass, fields
from pathlib import Path

import numpy as np
import torch

from flygym_tpu_torch.engine.actuation import SUPPORTED_KINDS
from flygym_tpu_torch.engine.linalg import LdlTables
from flygym_tpu_torch.engine.model import PhysicsModel, State

__all__ = [
    "BENCHMARK_FLY",
    "BENCHMARK_GOLDEN",
    "CompiledModel",
    "model_from_numpy",
    "load_compiled",
    "load_golden",
]

ASSETS = Path(__file__).resolve().parents[1] / "assets"
BENCHMARK_FLY = ASSETS / "benchmark_fly.npz"
BENCHMARK_GOLDEN = ASSETS / "benchmark_fly_golden.npz"


@dataclass(frozen=True)
class CompiledModel:
    """A compiled world: the model, its one-world initial state, and per fly
    the index maps of ``flygym_tpu.Simulation`` (``simulation.py:88-150``)
    as exported: ``qpos_adrs``, ``qvel_adrs``, ``body_ids``, ``site_ids``,
    ``act_ids`` by actuator type, ``adh_ids``, ``sensor_slots``, and the DoF
    orders ``jointdofs`` and ``actuated_dofs`` by type as
    (leg, parent link, child link, axis) tuples."""

    model: PhysicsModel
    initial_state: State
    flies: dict

    @property
    def fly_names(self) -> list:
        return list(self.flies)


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return torch.tensor(a, dtype=torch.float32)
    if a.dtype.kind in "iu":
        return torch.tensor(a, dtype=torch.int64)
    if a.dtype.kind == "b":
        return torch.tensor(a)
    raise TypeError(f"unsupported array dtype {a.dtype}")


def _tuples(x):
    """JSON lists back to the nested tuples of the JAX static fields."""
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def _refuse_unported(static: dict, arrays: dict) -> None:
    kinds = set(np.unique(arrays["model.act_kind"]).tolist())
    checks = [
        (kinds <= set(SUPPORTED_KINDS), f"actuator kinds {sorted(kinds)}"),
        (static["na"] == 0, "activation states (na > 0)"),
        (static["ncand_pair"] == 0, "fly-fly contact pair rows"),
        (not static["has_hfield"], "heightfield terrain"),
        (static["solver_type"] != "pgs", "the PGS solver"),
        (not static["solver_exact"], "solver_exact"),
        (static["condim"] == 3, f"condim {static['condim']}"),
        (not static["welds"], "weld constraints"),
        (not static["differentiable"], "differentiable mode"),
    ]
    missing = [what for ok, what in checks if not ok]
    if missing:
        raise NotImplementedError(
            "the PyTorch port does not support: " + ", ".join(missing)
        )


def model_from_numpy(arrays: dict, meta: dict) -> CompiledModel:
    """Build the port's compiled model from exported arrays and metadata.

    Args:
        arrays: ``{"model.<field>": ndarray, "state.<field>": ndarray}``.
        meta: ``{"model": static fields, "flies": per-fly index maps}``.
    """
    static = meta["model"]
    _refuse_unported(static, arrays)
    kw = {}
    for f in fields(PhysicsModel):
        if f.name == "ldl":
            continue
        if f.name in static:
            kw[f.name] = _tuples(static[f.name])
        else:
            kw[f.name] = _tensor(arrays[f"model.{f.name}"])
    kw["ancestor_jumps"] = tuple(
        torch.tensor(j, dtype=torch.int64) for j in static["ancestor_jumps"]
    )
    kw["ldl"] = LdlTables.from_static(
        static["nv"], kw["dof_chains"], kw["dof_height_levels"], kw["dof_depth_levels"]
    )
    state = State(
        **{f.name: _tensor(arrays[f"state.{f.name}"])[None] for f in fields(State)}
    )
    return CompiledModel(model=PhysicsModel(**kw), initial_state=state, flies=meta["flies"])


def _read_npz(path):
    with np.load(path, allow_pickle=False) as npz:
        meta = json.loads(str(npz["meta"]))
        arrays = {k: npz[k] for k in npz.files if k != "meta"}
    return arrays, meta


def load_compiled(path=BENCHMARK_FLY) -> CompiledModel:
    """Load a compiled model written by ``scripts/export_torch_model.py``
    (by default the benchmark fly)."""
    return model_from_numpy(*_read_npz(path))


def load_golden(path=BENCHMARK_GOLDEN) -> dict:
    """The JAX golden of the replay: ``state`` (the settled batched
    :class:`State`), ``targets`` (B, n_steps, n_dofs), and the JAX
    trajectory ``qpos``, ``qvel``, ``sensordata`` (n_steps, B, ...)."""
    arrays, meta = _read_npz(path)
    out = {k: v for k, v in arrays.items() if not k.startswith("state.")}
    out["state"] = State(
        **{f.name: _tensor(arrays[f"state.{f.name}"]) for f in fields(State)}
    )
    out["meta"] = meta
    return out
