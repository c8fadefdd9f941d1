"""Export the hybrid controller on blocks terrain (config 3) for the PyTorch port.

Config 3 of ``BASELINE.json`` is the hybrid controller on blocks terrain with
mechanosensory feedback and adhesion; ``examples/08_hybrid_rugged_terrain.py``
builds it: one LEGS_ONLY fly with 42 position actuators at kp 50 and leg
adhesion, spawned at (0, 0, 2.0) on ``BlocksTerrainWorld(block_size=1.3,
height_range=(0.2, 0.35))`` (a 320 x 320 height grid, cell 0.25 mm, xy0
(-40, -40)). This script runs the JAX package on the CPU and writes:

- ``flygym_tpu_torch/assets/terrain_fly.npz``: the compiled world, as
  ``scripts/export_torch_model.py`` writes the benchmark fly. The fly's
  index maps add ``tip_bodies``, the six ``tarsus5`` body ids in leg order
  (example 08, lines 68-71), and ``meta["clip_keypoints"]`` holds the
  Spotlight clip's keypoint labels, which the clip stores as a pickled
  object array (the port's loaders refuse pickles).
- ``flygym_tpu_torch/assets/terrain_fly_golden.npz``: 8 worlds whose roots
  are moved by seeded offsets (``offsets``, uniform in +-20 mm) and settled
  for 2,496 vmapped engine steps at the neutral joint targets with adhesion
  on; the initial state of the vmapped ``HybridController`` (world i seeded
  with i); and 48 closed-loop steps of example 08's loop recorded twice:

  - ``emitter.*``: the mega-step emitter (``flygym_tpu.ops.megastep.
    emit_step``), stepped eagerly, with ground planes from
    ``make_plane_sampler`` every 8 steps, as the mega-step path samples them
    (``emitter.planes`` keeps the 6 samples);
  - ``engine.*``: the vmapped engine step.

  Each records per step ``qpos``, ``qvel`` and ``sensordata``, and the
  controller's state after the last step.

Run from the repository root (about 10 minutes on one CPU core, most of it
the eager emitter)::

    JAX_PLATFORMS=cpu python scripts/export_terrain_golden.py
"""

import dataclasses
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "flygym_tpu_torch" / "assets"
MODEL_PATH = ASSETS / "terrain_fly.npz"
GOLDEN_PATH = ASSETS / "terrain_fly_golden.npz"
CLIP_PATH = REPO / "flygym_tpu" / "assets" / "demo" / "spotlight_behavior_clip.npz"

FLY_NAME = "rugged"
GOLDEN_WORLDS = 8
GOLDEN_SETTLE_STEPS = 2496
GOLDEN_STEPS = 48
TERRAIN_RESAMPLE = 8
ROOT_OFFSET_MM = 20.0
SEED = 0
CONTROLLER_FIELDS = ("phase", "amplitude", "damplitude", "retraction", "stumbling")


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_world():
    """Example 08's fly and blocks terrain."""
    from flygym_tpu.anatomy import ActuatedDOFPreset, AxisOrder, JointPreset, Skeleton
    from flygym_tpu.compose import ActuatorType, BlocksTerrainWorld, Fly, KinematicPosePreset
    from flygym_tpu.utils.math import Rotation3D

    fly = Fly(name=FLY_NAME)
    fly.add_joints(
        Skeleton(axis_order=AxisOrder.YPR, joint_preset=JointPreset.LEGS_ONLY),
        neutral_pose=KinematicPosePreset.NEUTRAL,
    )
    dofs = fly.skeleton.get_actuated_dofs_from_preset(ActuatedDOFPreset.LEGS_ACTIVE_ONLY)
    fly.add_actuators(dofs, ActuatorType.POSITION, kp=50.0,
                      neutral_input=KinematicPosePreset.NEUTRAL)
    fly.add_leg_adhesion()
    world = BlocksTerrainWorld(block_size=1.3, height_range=(0.2, 0.35))
    world.add_fly(fly, (0, 0, 2.0), Rotation3D("quat", (1, 0, 0, 0)))
    return fly, world


def tip_bodies(world, fly) -> list:
    return [int(world.compiled.body_name2id[f"{fly.name}/{leg}_tarsus5"])
            for leg in fly.get_legs_order()]


def clip_keypoints() -> list:
    with np.load(CLIP_PATH, allow_pickle=True) as npz:
        return [list(k) for k in npz["keypoints"].tolist()]


def root_offsets(n_worlds=GOLDEN_WORLDS, seed=SEED) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-ROOT_OFFSET_MM, ROOT_OFFSET_MM, (n_worlds, 2)).astype(np.float32)


def make_controller(fly, timestep):
    from flygym_tpu.compose import ActuatorType
    from flygym_tpu.control import CPGController, HybridController, extract_preprogrammed_steps
    from flygym_tpu.demo import MotionSnippet

    steps = extract_preprogrammed_steps(
        MotionSnippet(), fly.get_actuated_jointdofs_order(ActuatorType.POSITION)
    )
    return HybridController(cpg=CPGController(steps, timestep=timestep))


def settled_state(sim, fly, offsets, settle_steps=GOLDEN_SETTLE_STEPS):
    """The batch's roots moved by ``offsets`` (forward kinematics redone),
    then vmapped engine steps at the neutral targets with adhesion on."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine.kinematics import forward_kinematics
    from flygym_tpu.engine.model import compute_site_xpos
    from flygym_tpu.engine.step import step

    sim.set_leg_adhesion_states(fly.name, np.ones((offsets.shape[0], 6), np.float32))
    st = sim.state
    model = sim.model
    _body, qadr, _vadr = model.free_joints[0]
    qpos = st.qpos.at[:, qadr : qadr + 2].add(jnp.asarray(offsets))
    xpos, xquat = jax.vmap(lambda q: forward_kinematics(model, q))(qpos)
    site = jax.vmap(lambda p, q: compute_site_xpos(model, p, q))(xpos, xquat)
    st = dataclasses.replace(st, qpos=qpos, xpos=xpos, xquat=xquat, site_xpos=site)
    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0)))
    for _ in range(settle_steps):
        st = vstep(model, st)
    return st


def make_controls(hybrid, act_ids, adh_ids, tips, slots):
    """Example 08's readouts and controller over the batch, run eagerly (op
    by op, as the emitter runs)."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine.maths import quat_rotate

    vhybrid = jax.vmap(hybrid)

    def controls(st, cs):
        tip_z = st.xpos[:, tips, 2]
        sensor = st.contact_sensordata[:, slots]
        frame_force = sensor[..., 1:4]
        f_world = frame_force[..., 0:1] * sensor[..., 10:13] + frame_force[..., 1:2] * sensor[..., 13:16]
        heading = quat_rotate(st.xquat[:, 1], jnp.array([1.0, 0.0, 0.0], jnp.float32))
        cs, targets, adhesion = vhybrid(cs, tip_z, f_world, heading)
        ctrl = st.ctrl.at[:, act_ids].set(targets).at[:, adh_ids].set(adhesion)
        return dataclasses.replace(st, ctrl=ctrl), cs

    return controls


def controller_arrays(cs) -> dict:
    return {
        "phase": np.asarray(cs.cpg.phase), "amplitude": np.asarray(cs.cpg.amplitude),
        "damplitude": np.asarray(cs.cpg.damplitude),
        "retraction": np.asarray(cs.retraction), "stumbling": np.asarray(cs.stumbling),
    }


def engine_loop(model, st, cs, controls, n_steps=GOLDEN_STEPS) -> dict:
    import jax

    from flygym_tpu.engine.step import step

    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0)))
    rec = {"qpos": [], "qvel": [], "sensordata": []}
    for _ in range(n_steps):
        st, cs = controls(st, cs)
        st = vstep(model, st)
        rec["qpos"].append(np.asarray(st.qpos))
        rec["qvel"].append(np.asarray(st.qvel))
        rec["sensordata"].append(np.asarray(st.contact_sensordata))
    out = {f"engine.{k}": np.stack(v) for k, v in rec.items()}
    out.update({f"engine.controller.{k}": v for k, v in controller_arrays(cs).items()})
    return out


def emitter_loop(model, st, cs, controls, n_steps=GOLDEN_STEPS) -> dict:
    """The mega-step emitter stepped eagerly; planes from the JAX sampler of
    the cached pose every ``TERRAIN_RESAMPLE`` steps."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine.model import State
    from flygym_tpu.engine.terrain import make_plane_sampler
    from flygym_tpu.ops import megastep

    jst = megastep._Static(model)
    sampler = jax.jit(make_plane_sampler(model))
    cols = lambda x: [jnp.asarray(np.asarray(x)[:, i]) for i in range(np.asarray(x).shape[1])]
    pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
    rows = lambda vecs, width: (
        np.stack([pack(p) for p in vecs], axis=1) if vecs
        else np.zeros((st.qpos.shape[0], 0, width), np.float32)
    )
    rec = {"qpos": [], "qvel": [], "sensordata": []}
    sampled = []
    for t in range(n_steps):
        if t % TERRAIN_RESAMPLE == 0:
            planes = np.asarray(sampler(st.xpos, st.xquat))
            sampled.append(planes)
            terrain = [tuple(jnp.asarray(planes[:, c, k]) for k in range(4))
                       for c in range(planes.shape[1])]
        st, cs = controls(st, cs)
        r = megastep.emit_step(jst, cols(st.qpos), cols(st.qvel), cols(st.ctrl), cols(st.act),
                               cols(st.qacc), terrain)
        st = State(
            qpos=jnp.asarray(pack(r["qpos"])),
            qvel=jnp.asarray(pack(r["qvel"])),
            ctrl=st.ctrl,
            act=st.act,
            time=st.time + model.timestep,
            qacc=jnp.asarray(pack(r["qacc"])),
            xpos=jnp.asarray(rows(r["xpos"], 3)),
            xquat=jnp.asarray(rows(r["xquat"], 4)),
            site_xpos=jnp.asarray(rows(r["site_xpos"], 3)),
            actuator_force=jnp.asarray(pack(r["actuator_force"])),
            contact_sensordata=jnp.asarray(rows(r["sensordata"], 16)),
        )
        rec["qpos"].append(np.asarray(st.qpos))
        rec["qvel"].append(np.asarray(st.qvel))
        rec["sensordata"].append(np.asarray(st.contact_sensordata))
        print(f"emitter step {t + 1}/{n_steps}", flush=True)
    out = {f"emitter.{k}": np.stack(v) for k, v in rec.items()}
    out["emitter.planes"] = np.stack(sampled)
    out.update({f"emitter.controller.{k}": v for k, v in controller_arrays(cs).items()})
    return out


def export_model():
    """Example 08's world compiled by the JAX package and flattened:
    ``(fly, world, jax simulation, arrays, meta)``."""
    import flygym_tpu

    fly, world = build_world()
    sim = flygym_tpu.Simulation(world)
    arrays, meta = _load_script("export_torch_model").export(world, sim)
    meta["flies"][fly.name]["tip_bodies"] = tip_bodies(world, fly)
    meta["clip_keypoints"] = clip_keypoints()
    return fly, world, sim, arrays, meta


def main():
    # The goldens are taken on the CPU backend (full fp32 matmuls).
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["FLYGYM_TPU_MEGASTEP"] = "0"
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from flygym_tpu.batch import BatchSimulation
    from flygym_tpu.compose import ActuatorType
    from flygym_tpu.control import HybridState
    from flygym_tpu.engine.model import State

    exporter = _load_script("export_torch_model")
    fly, world, _sim, arrays, meta = export_model()
    tips = meta["flies"][fly.name]["tip_bodies"]
    exporter.save_npz(MODEL_PATH, arrays, meta)
    print(f"wrote {MODEL_PATH} ({MODEL_PATH.stat().st_size} bytes)", flush=True)

    bsim = BatchSimulation(world, GOLDEN_WORLDS)
    offsets = root_offsets()
    settled = settled_state(bsim, fly, offsets)
    print("settled", flush=True)
    model = bsim.model
    hybrid = make_controller(fly, bsim.timestep)
    cs0 = jax.tree.map(lambda *x: jnp.stack(x), *[HybridState.init(i) for i in range(GOLDEN_WORLDS)])
    flies = meta["flies"][fly.name]
    controls = make_controls(
        hybrid, jnp.asarray(flies["act_ids"][ActuatorType.POSITION.value]),
        jnp.asarray(flies["adh_ids"]), jnp.asarray(tips), jnp.asarray(flies["sensor_slots"]),
    )
    golden = {
        f"state.{f.name}": np.asarray(getattr(settled, f.name))
        for f in dataclasses.fields(State)
    }
    golden["offsets"] = offsets
    golden.update({f"controller.{k}": v for k, v in controller_arrays(cs0).items()})
    golden.update(engine_loop(model, settled, cs0, controls))
    print("engine golden done", flush=True)
    golden.update(emitter_loop(model, settled, cs0, controls))
    gmeta = {
        "n_worlds": GOLDEN_WORLDS,
        "settle_steps": GOLDEN_SETTLE_STEPS,
        "n_steps": GOLDEN_STEPS,
        "terrain_resample": TERRAIN_RESAMPLE,
        "root_offset_mm": ROOT_OFFSET_MM,
        "seed": SEED,
    }
    exporter.save_npz(GOLDEN_PATH, golden, gmeta)
    print(f"wrote {GOLDEN_PATH} ({GOLDEN_PATH.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
