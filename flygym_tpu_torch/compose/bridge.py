"""The bridge from a compiled model as numpy data to the port.

The port composes and compiles worlds itself
(:mod:`flygym_tpu_torch.compose`: ``Fly``, the worlds and
``ModelSpec.compile_arrays``), and it loads the ``.npz`` files that the JAX
package's ``scripts/export_*.py`` scripts wrote. Both take the same form:
every array field of the compiled model and of the initial state, the static
fields and the flies' index maps, as ``scripts/export_torch_model.py``
writes them; :func:`model_from_numpy` turns them into the port's
:class:`~flygym_tpu_torch.engine.model.PhysicsModel`, the one way into it.
An RL env's world (``scripts/export_env_golden.py``) adds ``meta["env"]``:
the env's index maps and tables, kept as :attr:`CompiledModel.env`. The
blocks-terrain world of config 3 (``scripts/export_terrain_golden.py``)
carries its height grid in the model's ``hfield_*`` fields. Example 11's two
stacked flies (``scripts/export_twofly_golden.py``) carry their fly-fly pair
rows in the candidate table (``can_geom2``, ``can_body2``, ``ncand_pair``).
The default two-fly contact preset (55 x 55 pair rows) and the 3-fly pile
(``scripts/export_compressed_golden.py``) add their compression: the pair
rows' groups (``pair_groups``) and ``pair_compress``. The muscle-driven fly,
the fly with one actuator kind per leg and the strict replay's fly
(``scripts/export_actuator_golden.py``) carry every actuator kind, their
activation states (``State.act``, ``act_actadr``, ``act_dynprm``,
``act_muscleprm``, ``act_lengthrange``, ``act_acc0``) and ``solver_exact``.
The same script writes the tethered motor fly, a world without contact
candidates (``ncand`` 0, no sensors, no adhesion). Condim 1, 4 and 6, the
PGS solver and soft welds (``welds``) are read as the JAX compile wrote
them; ``scripts/export_taxis_golden.py`` writes the visual-taxis world (its
fly's maps add ``eye_bodies``), the CPG walking world and the condim-6 fly.
``meta["render"]`` (the cameras, geom names and body names the renderer
reads) is kept as :attr:`CompiledModel.render`; every world the port
compiles has it, and of the exported files the benchmark fly, example 11's
two flies and config 3's terrain fly.

Differentiable mode, which the port does not have yet, is refused here
with ``NotImplementedError`` rather than simulated wrongly.
"""

import json
from dataclasses import dataclass, fields
from pathlib import Path

import numpy as np
import torch

from flygym_tpu_torch.engine.linalg import LdlTables
from flygym_tpu_torch.engine.model import PhysicsModel, State

__all__ = [
    "BENCHMARK_FLY",
    "BENCHMARK_GOLDEN",
    "CONDIM6_FLY",
    "CONDIM6_GOLDEN",
    "CPG_FLY",
    "CPG_GOLDEN",
    "CompiledModel",
    "ENV_FLY",
    "ENV_GOLDEN",
    "MIXED_FLY",
    "MIXED_GOLDEN",
    "MUSCLE_FLY",
    "MUSCLE_GOLDEN",
    "STRICT_FLY",
    "STRICT_GOLDEN",
    "TAXIS_FLY",
    "TAXIS_GOLDEN",
    "TERRAIN_FLY",
    "TERRAIN_GOLDEN",
    "TETHERED_FLY",
    "TETHERED_GOLDEN",
    "THREEFLY",
    "THREEFLY_GOLDEN",
    "TWOFLY",
    "TWOFLY_FULL",
    "TWOFLY_FULL_GOLDEN",
    "TWOFLY_GOLDEN",
    "load_actuator_golden",
    "load_env_golden",
    "load_loop_golden",
    "load_terrain_golden",
    "load_twofly_golden",
    "read_meta",
    "model_from_numpy",
    "physics_model",
    "load_compiled",
    "load_golden",
]

ASSETS = Path(__file__).resolve().parents[1] / "assets"
BENCHMARK_FLY = ASSETS / "benchmark_fly.npz"
BENCHMARK_GOLDEN = ASSETS / "benchmark_fly_golden.npz"
ENV_FLY = ASSETS / "env_fly.npz"
ENV_GOLDEN = ASSETS / "env_fly_golden.npz"
TERRAIN_FLY = ASSETS / "terrain_fly.npz"
TERRAIN_GOLDEN = ASSETS / "terrain_fly_golden.npz"
TWOFLY = ASSETS / "twofly.npz"
TWOFLY_GOLDEN = ASSETS / "twofly_golden.npz"
TWOFLY_FULL = ASSETS / "twofly_full.npz"
TWOFLY_FULL_GOLDEN = ASSETS / "twofly_full_golden.npz"
THREEFLY = ASSETS / "threefly.npz"
THREEFLY_GOLDEN = ASSETS / "threefly_golden.npz"
STRICT_FLY = ASSETS / "strict_fly.npz"
STRICT_GOLDEN = ASSETS / "strict_fly_golden.npz"
MUSCLE_FLY = ASSETS / "muscle_fly.npz"
MUSCLE_GOLDEN = ASSETS / "muscle_fly_golden.npz"
MIXED_FLY = ASSETS / "mixed_fly.npz"
MIXED_GOLDEN = ASSETS / "mixed_fly_golden.npz"
TETHERED_FLY = ASSETS / "tethered_fly.npz"
TETHERED_GOLDEN = ASSETS / "tethered_fly_golden.npz"
TAXIS_FLY = ASSETS / "taxis_fly.npz"
TAXIS_GOLDEN = ASSETS / "taxis_fly_golden.npz"
CPG_FLY = ASSETS / "cpg_fly.npz"
CPG_GOLDEN = ASSETS / "cpg_fly_golden.npz"
CONDIM6_FLY = ASSETS / "condim6_fly.npz"
CONDIM6_GOLDEN = ASSETS / "condim6_fly_golden.npz"


@dataclass(frozen=True)
class CompiledModel:
    """A compiled world: the model, its one-world initial state, and per fly
    the index maps of ``flygym_tpu.Simulation`` (``simulation.py:88-150``)
    as exported: ``qpos_adrs``, ``qvel_adrs``, ``body_ids``, ``site_ids``,
    ``act_ids`` by actuator type, ``adh_ids``, ``sensor_slots``, and the DoF
    orders ``jointdofs`` and ``actuated_dofs`` by type as
    (leg, parent link, child link, axis) tuples. ``env`` is the RL env's
    ``meta["env"]`` where the world was exported for one, else None.
    ``render`` is ``meta["render"]`` where the export wrote it (the cameras,
    the geom names and the body name map the renderer reads), else None.
    ``names`` holds the compiler's name→index maps of a world the port
    compiled (:meth:`~flygym_tpu_torch.compose.spec.ModelSpec.compile`),
    read as attributes (``compiled.body_name2id``); None for a loaded
    file."""

    model: PhysicsModel
    initial_state: State
    flies: dict
    env: dict | None = None
    render: dict | None = None
    names: dict | None = None

    @property
    def fly_names(self) -> list:
        return list(self.flies)

    def __getattr__(self, name):
        # A world compiled by the port carries the compiler's name maps
        # (``body_name2id``, ``hinge_qadr``, ... as the JAX package's
        # ``CompiledModel`` names them); a loaded ``.npz`` file has none.
        names = self.__dict__.get("names")
        if names is not None and name in names:
            return names[name]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")


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


def _refuse_unported(static: dict) -> None:
    """Differentiable mode, which the port does not have yet, is refused."""
    if static["differentiable"]:
        raise NotImplementedError(
            "the PyTorch port does not support differentiable mode (gradients "
            "through the step wait for the tree-LDL kernels under autograd)"
        )


def model_from_numpy(arrays: dict, meta: dict) -> CompiledModel:
    """Build the port's compiled model from exported arrays and metadata.

    Args:
        arrays: ``{"model.<field>": ndarray, "state.<field>": ndarray}``.
        meta: ``{"model": static fields, "flies": per-fly index maps}``.
    """
    static = meta["model"]
    state = State(
        **{f.name: _tensor(arrays[f"state.{f.name}"])[None] for f in fields(State)}
    )
    return CompiledModel(
        model=physics_model(arrays, static), initial_state=state, flies=meta["flies"],
        env=meta.get("env"), render=meta.get("render"),
    )


def physics_model(arrays: dict, static: dict) -> PhysicsModel:
    """The :class:`PhysicsModel` of ``arrays``' ``model.<field>`` entries and
    the static fields ``static`` (``meta["model"]``), on the CPU."""
    _refuse_unported(static)
    kw = {}
    for f in fields(PhysicsModel):
        if f.name in ("ldl", "weld_ref"):
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
    kw["weld_ref"] = tuple(
        torch.tensor([w[i] for w in kw["welds"]], dtype=torch.float32).reshape(-1, n)
        for i, n in ((3, 3), (4, 4), (6, 5))
    )
    return PhysicsModel(**kw)


def _read_npz(path):
    with np.load(path, allow_pickle=False) as npz:
        meta = json.loads(str(npz["meta"]))
        arrays = {k: npz[k] for k in npz.files if k != "meta"}
    return arrays, meta


def read_meta(path) -> dict:
    """The JSON metadata of an exported ``.npz`` file."""
    return _read_npz(path)[1]


def load_compiled(path=BENCHMARK_FLY) -> CompiledModel:
    """Load a compiled model written by ``scripts/export_torch_model.py``
    (by default the benchmark fly)."""
    return model_from_numpy(*_read_npz(path))


def _state_of(arrays: dict) -> State:
    return State(**{f.name: _tensor(arrays[f"state.{f.name}"]) for f in fields(State)})


def load_golden(path=BENCHMARK_GOLDEN) -> dict:
    """The JAX golden of the replay: ``state`` (the settled batched
    :class:`State`), ``targets`` (B, n_steps, n_dofs), and the JAX
    trajectory ``qpos``, ``qvel``, ``sensordata`` (n_steps, B, ...)."""
    arrays, meta = _read_npz(path)
    out = {k: v for k, v in arrays.items() if not k.startswith("state.")}
    out["state"] = _state_of(arrays)
    out["meta"] = meta
    return out


def load_env_golden(path=ENV_GOLDEN) -> dict:
    """The JAX golden of the RL env: ``state`` (the settled batched
    :class:`State`), the actions ``joints`` (n_steps, B, 42) and
    ``adhesion`` (n_steps, B, 6), and for the two JAX paths (``engine``,
    ``emitter``) per env step ``qpos``, ``qvel``, ``obs`` (a dict of the
    observations), ``reward`` and ``done``."""
    arrays, meta = _read_npz(path)
    out = {"state": _state_of(arrays), "meta": meta,
           "joints": arrays["joints"], "adhesion": arrays["adhesion"]}
    for path_name in ("engine", "emitter"):
        rec = {"obs": {}}
        for key, value in arrays.items():
            if key.startswith(f"{path_name}.obs."):
                rec["obs"][key[len(f"{path_name}.obs."):]] = value
            elif key.startswith(f"{path_name}."):
                rec[key[len(path_name) + 1:]] = value
        out[path_name] = rec
    return out


def load_terrain_golden(path=TERRAIN_GOLDEN) -> dict:
    """The JAX golden of config 3's closed loop: ``state`` (the settled
    batched :class:`State`), ``offsets`` (B, 2) root offsets, ``controller``
    (the initial controller state as numpy arrays), and for the two JAX paths
    (``engine``, ``emitter``) per step ``qpos``, ``qvel``, ``sensordata``
    and the final ``controller`` state; ``emitter["planes"]`` holds the
    ground planes that path sampled every ``meta["terrain_resample"]``
    steps."""
    arrays, meta = _read_npz(path)
    out = {"state": _state_of(arrays), "meta": meta, "offsets": arrays["offsets"],
           "controller": {}}
    for path_name in ("engine", "emitter"):
        out[path_name] = {"controller": {}}
    for key, value in arrays.items():
        head, _, rest = key.partition(".")
        if head == "controller":
            out["controller"][rest] = value
        elif head in ("engine", "emitter"):
            sub, _, name = rest.partition(".")
            if sub == "controller":
                out[head]["controller"][name] = value
            else:
                out[head][rest] = value
    return out


def _load_probe_golden(path, keys) -> dict:
    """A golden with a conditioning probe: ``state`` (the settled batched
    :class:`State`), ``meta``, each of ``keys`` the file holds, and the
    ``emitter``, ``engine`` and ``probe`` records, one dict each."""
    arrays, meta = _read_npz(path)
    out = {"state": _state_of(arrays), "meta": meta}
    out.update({key: arrays[key] for key in keys if key in arrays})
    for key, value in arrays.items():
        head, _, rest = key.partition(".")
        if head in ("emitter", "engine", "probe"):
            out.setdefault(head, {})[rest] = value
    return out


def load_twofly_golden(path=TWOFLY_GOLDEN) -> dict:
    """The JAX golden of stacked flies: ``state`` (the settled batched
    :class:`State`), ``offsets`` of the upper flies' roots, and for the JAX
    emitter, the JAX engine and the engine's conditioning probe
    (``emitter``, ``engine``, ``probe``) per step ``qpos``, ``qvel`` and
    ``sensordata``. The goldens of ``scripts/export_compressed_golden.py``
    (:data:`TWOFLY_FULL_GOLDEN`, :data:`THREEFLY_GOLDEN`) add the winners
    the JAX emitter was fed, ``emitter["widx"]`` (chunks, B, n_groups) with
    a chunk per ``meta["winner_k"]`` steps, and ``settled_gap``, each
    fly's root height above the fly below after the settle."""
    return _load_probe_golden(path, ("offsets", "settled_gap"))


def load_actuator_golden(path) -> dict:
    """The JAX golden of a world of ``scripts/export_actuator_golden.py``
    (:data:`STRICT_GOLDEN`, :data:`MUSCLE_GOLDEN`, :data:`MIXED_GOLDEN`,
    :data:`TETHERED_GOLDEN`):
    ``state`` (the settled batched :class:`State`), ``ctrl`` (n_steps, B,
    nu) the controls of each step, and for the JAX emitter, the JAX engine
    and the engine's conditioning probe (``emitter``, ``engine``,
    ``probe``) per step ``qpos``, ``qvel``, ``act`` and ``sensordata``."""
    return _load_probe_golden(path, ("ctrl",))


def load_loop_golden(path=TAXIS_GOLDEN) -> dict:
    """The JAX golden of a closed loop of ``scripts/export_taxis_golden.py``
    (:data:`TAXIS_GOLDEN`, :data:`CPG_GOLDEN`): ``state`` (the settled
    batched :class:`State`), ``controller`` (the initial CPG state as numpy
    arrays), and for the JAX engine, the JAX emitter and the engine's
    conditioning probe (``engine``, ``emitter``, ``probe``) per step (per
    control step for the taxis) ``qpos``, ``qvel`` and the CPG's ``phase``,
    and for the taxis ``vision``, ``drive``, and ``xpos`` and ``xquat``
    after the control step's physics (the poses the next one renders)."""
    out = _load_probe_golden(path, ())
    arrays, _meta = _read_npz(path)
    out["controller"] = {k.partition(".")[2]: v for k, v in arrays.items()
                         if k.startswith("controller.")}
    return out
