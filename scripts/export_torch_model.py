"""Export the compiled benchmark fly for the PyTorch port.

The port (``flygym_tpu_torch``) does not compile worlds itself: composing a
``World`` needs JAX and PyYAML. This script runs the JAX package on the CPU
and writes what the port needs as plain numpy data:

- ``flygym_tpu_torch/assets/benchmark_fly.npz``: every array field of the
  compiled ``PhysicsModel`` (``can_invweight`` as the JAX compile filled it),
  the initial ``State``, and a JSON ``meta`` entry with the model's static
  fields, the fly's index maps and its actuated DoF order.
- ``flygym_tpu_torch/assets/benchmark_fly_golden.npz``: the JAX state of 8
  batched benchmark worlds after a long settle with adhesion on, the next 50
  replay steps' targets, and the JAX trajectory of qpos, qvel and contact
  sensor data over those steps.

Run from the repository root::

    JAX_PLATFORMS=cpu python scripts/export_torch_model.py
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "flygym_tpu_torch" / "assets"
MODEL_PATH = ASSETS / "benchmark_fly.npz"
GOLDEN_PATH = ASSETS / "benchmark_fly_golden.npz"

GOLDEN_WORLDS = 8
GOLDEN_SETTLE_STEPS = 2500
GOLDEN_STEPS = 50


def _dof_tuple(dof):
    return [dof.child.pos, dof.parent.link, dof.child.link, dof.axis.value]


def _fly_maps(sim, fly_name, fly):
    """The ``Simulation`` index maps of one fly (``simulation.py:88-150``)."""
    from flygym_tpu.compose.fly import ActuatorType

    def ids(x):
        return [int(i) for i in np.asarray(x)]

    act_ids = {
        ty.value: ids(sim._act_ids_by_type[ty][fly_name])
        for ty in ActuatorType
        if fly_name in sim._act_ids_by_type[ty]
    }
    actuated_dofs = {
        ty: [_dof_tuple(d) for d in fly.get_actuated_jointdofs_order(ty)]
        for ty in act_ids
        if ty != ActuatorType.ADHESION.value
    }
    return {
        "qpos_adrs": ids(sim._qpos_adrs[fly_name]),
        "qvel_adrs": ids(sim._qvel_adrs[fly_name]),
        "body_ids": ids(sim._body_ids[fly_name]),
        "site_ids": ids(sim._site_ids[fly_name]),
        "act_ids": act_ids,
        "adh_ids": ids(sim._adh_ids.get(fly_name, [])),
        "sensor_slots": ids(sim._sensor_slots.get(fly_name, [])),
        "jointdofs": [_dof_tuple(d) for d in fly.get_jointdofs_order()],
        "actuated_dofs": actuated_dofs,
        "legs": list(fly.get_legs_order()),
    }


def render_meta(world):
    """What the port's renderer needs of a compiled world: every camera
    (``full_identifier``, ``mode``, ``pos``, ``quat``, ``fovy`` and its
    ``target`` as a body id, or None), the geom names by geom id (the mesh
    SDF pack matches segments by name) and the body name map (light
    targets)."""
    compiled = world.compiled
    cameras = []
    for cam in world.spec.cameras:
        cameras.append({
            "name": cam.name,
            "full_identifier": cam.full_identifier,
            "mode": cam.mode,
            "pos": [float(x) for x in cam.pos],
            "quat": [float(x) for x in cam.quat],
            "fovy": float(cam.fovy),
            "target": None if cam.target is None else compiled.body_name2id[cam.target],
        })
    id2geom = {v: k for k, v in compiled.geom_name2id.items()}
    return {
        "cameras": cameras,
        "geom_names": [id2geom.get(g, "") for g in range(int(compiled.model.ngeom))],
        "body_name2id": {k: int(v) for k, v in compiled.body_name2id.items()},
    }


def export(world, sim, render=False):
    """Flatten a compiled world into ``(arrays, meta)``.

    Args:
        world: The composed world that ``sim`` was built from.
        sim: A ``flygym_tpu.Simulation`` (or ``BatchSimulation``) of it.
        render: Add :func:`render_meta` as ``meta["render"]``.

    Returns:
        arrays: ``{"model.<field>": ndarray, "state.<field>": ndarray}`` for
            every array field of the model and of the unbatched initial state.
        meta: JSON-serialisable dict with the model's static fields
            (``meta["model"]``), the per-fly index maps (``meta["flies"]``)
            and, with ``render``, the renderer's names (``meta["render"]``).
    """
    from flygym_tpu.engine.model import PhysicsModel, State

    model = sim.model
    arrays, static = {}, {}
    for f in dataclasses.fields(PhysicsModel):
        value = getattr(model, f.name)
        if f.metadata.get("static"):
            static[f.name] = value
        else:
            arrays[f"model.{f.name}"] = np.asarray(value)
    for f in dataclasses.fields(State):
        arrays[f"state.{f.name}"] = np.asarray(getattr(sim._initial_state, f.name))
    meta = {
        "model": json.loads(json.dumps(static)),
        "flies": {
            name: _fly_maps(sim, name, fly) for name, fly in world.fly_lookup.items()
        },
    }
    if render:
        meta["render"] = render_meta(world)
    return arrays, meta


def save_npz(path, arrays, meta):
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, meta=np.array(json.dumps(meta, sort_keys=True)), **arrays)


def build_benchmark():
    """The benchmark fly and world (``flygym_tpu/demo/benchmark.py``)."""
    from flygym_tpu.demo.benchmark import make_model

    fly, world, _cam = make_model()
    return fly, world


def make_golden(world, fly, n_worlds=GOLDEN_WORLDS,
                settle_steps=GOLDEN_SETTLE_STEPS, n_steps=GOLDEN_STEPS):
    """Settle ``n_worlds`` batched worlds, then record ``n_steps`` replay steps."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.batch import BatchSimulation
    from flygym_tpu.compose.fly import ActuatorType
    from flygym_tpu.demo.benchmark import ReplayTargetData
    from flygym_tpu.engine.model import State
    from flygym_tpu.engine.step import step

    sim = BatchSimulation(world, n_worlds)
    if sim._megastep is not None:
        raise RuntimeError("the golden is taken on the vmapped engine step")
    sim.set_leg_adhesion_states(fly.name, np.ones((n_worlds, 6), np.float32))
    sim.rollout(None, settle_steps, record_trajectory=False)
    settled = sim.state

    dof_order = fly.get_actuated_jointdofs_order(ActuatorType.POSITION)
    replay = ReplayTargetData(sim.model.timestep, dof_order)
    targets = replay.make_target_angles_all_worlds(n_worlds, n_steps)
    act_ids = jnp.asarray(sim._act_ids_by_type[ActuatorType.POSITION][fly.name])

    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0)))
    st = settled
    qpos, qvel, sensordata = [], [], []
    for i in range(n_steps):
        ctrl = st.ctrl.at[:, act_ids].set(jnp.asarray(targets[:, i]))
        st = vstep(sim.model, dataclasses.replace(st, ctrl=ctrl))
        qpos.append(np.asarray(st.qpos))
        qvel.append(np.asarray(st.qvel))
        sensordata.append(np.asarray(st.contact_sensordata))

    arrays = {
        f"state.{f.name}": np.asarray(getattr(settled, f.name))
        for f in dataclasses.fields(State)
    }
    arrays.update(
        targets=targets,
        qpos=np.stack(qpos),
        qvel=np.stack(qvel),
        sensordata=np.stack(sensordata),
    )
    meta = {"n_worlds": n_worlds, "settle_steps": settle_steps, "n_steps": n_steps}
    return arrays, meta


def main():
    # The golden is taken on the CPU backend (full fp32 matmuls).
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["FLYGYM_TPU_MEGASTEP"] = "0"
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import flygym_tpu

    fly, world = build_benchmark()
    sim = flygym_tpu.Simulation(world)
    arrays, meta = export(world, sim, render=True)
    save_npz(MODEL_PATH, arrays, meta)
    print(f"wrote {MODEL_PATH} ({MODEL_PATH.stat().st_size} bytes)")

    golden, gmeta = make_golden(world, fly)
    save_npz(GOLDEN_PATH, golden, gmeta)
    print(f"wrote {GOLDEN_PATH} ({GOLDEN_PATH.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
