"""Export the visual-taxis world (config 4), the CPG walking world (config 2),
the condim-6 benchmark fly and the engine-only solver worlds for the PyTorch
port.

Seven worlds, each compiled and run by the JAX package on the CPU:

- **Visual taxis** (``taxis_fly``): ``examples/07_visual_taxis.py``'s world,
  the benchmark fly of ``flygym_tpu/demo/benchmark.py:make_model`` spawned
  at (0, 0, 1.2) and the dark pillar ``add_object("pillar", (25, 12, 3),
  radius=3)``. The fly's maps add ``eye_bodies`` (its ``l_eye`` and
  ``r_eye`` body ids, as ``Retina.for_fly`` reads them).
- **CPG walking** (``cpg_fly``): ``examples/04_cpg_walking.py``'s world, the
  same fly at (0, 0, 1.2) on flat ground.
- **The condim-6 benchmark fly** (``condim6_fly``): the benchmark fly as
  ``make_model`` builds it, its ground contacts at condim 6
  (``ContactParams(condim=6)``: sliding, torsional and rolling friction,
  10 pyramid rows per contact); ``condim1_fly`` (frictionless, 1 row) and
  ``condim4_fly`` (sliding and torsional friction, 6 rows) likewise.
- **The soft-welded fly** (``softweld_fly``): the benchmark fly in a
  ``TetheredWorld(weld="soft")`` at (0, 0, 3): its root keeps its free
  joint, pinned by the reference's soft 6-DoF weld; no ground, so no
  contact candidate.
- **The PGS fly** (``pgs_fly``): the benchmark fly with the PGS solver
  (``options["solver"] = "pgs"``, projected Gauss-Seidel on the dual).

The last two run on the engine step only, in JAX as in the port (JAX's
mega-step gate refuses both, ``flygym_tpu/ops/megastep.py:976-981``).

Each is written as ``flygym_tpu_torch/assets/<name>.npz`` (as
``scripts/export_torch_model.py`` writes the benchmark fly) and
``<name>_golden.npz``: 8 worlds with adhesion on, settled 2,500 vmapped JAX
engine steps from the spawn at the neutral targets (``ROADMAP.md`` queue 3:
compare chained steps from a quiescent state), then recorded through two
JAX paths from the same settled state:

- ``engine.*``: the vmapped engine step;
- ``emitter.*``: the mega-step emitter (``flygym_tpu.ops.megastep.
  emit_step``) stepped eagerly on (B,) arrays;
- ``probe.*`` (the two closed loops only): the engine path again from the
  settled state perturbed by 1e-5 relative in qpos and 1e-5 absolute in
  qvel, the conditioning probe of ``scripts/export_twofly_golden.py``: how
  far the walk itself carries a difference of float32 rounding's size, so
  that a port's gap can be held to it at every step.

What each golden runs after the settle:

- ``taxis_fly``: 10 control steps of example 07's loop (lines 55-70) per
  world: the jnp retina (``Retina.render``, vmapped), JAX's
  ``object_azimuth_drive`` (gain 8), one step of the CPG with that drive
  (timestep ``sim.timestep``, world i's controller seeded with i), the
  targets and adhesion written into ``ctrl``, then 20 physics steps with
  ``ctrl`` held. The controller and the drive run eagerly, op by op. Each
  control step records ``vision`` (B, 2, 721, 2), ``drive`` (B, 6), the
  CPG ``phase``, and after the 20 steps ``qpos``, ``qvel``, ``xpos`` and
  ``xquat`` (the poses the next control step renders from).
- ``cpg_fly``: 40 steps of example 04's loop (lines 44-53): one CPG step
  at drive 1.0, the targets and adhesion into ``ctrl``, one physics step;
  per step ``qpos``, ``qvel`` and ``phase``.
- ``condim6_fly``: 20 steps of the Spotlight replay's targets (as the
  benchmark golden), per step ``qpos``, ``qvel``, ``act`` and
  ``sensordata``, and the controls ``ctrl``; ``condim1_fly`` and
  ``condim4_fly`` 4 steps.
- ``softweld_fly`` and ``pgs_fly``: 20 steps of the replay's targets through
  the engine alone (``engine.*`` only), settled 1,000 steps (the tether
  holds the soft-welded fly still; PGS settles the fly from the spawn).

Run from the repository root (about 40 minutes on one CPU core, most of it
the eager emitter; arguments name some of the worlds)::

    JAX_PLATFORMS=cpu python scripts/export_taxis_golden.py [taxis_fly cpg_fly condim1_fly ...]
"""

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "flygym_tpu_torch" / "assets"

GOLDEN_WORLDS = 8
SETTLE_STEPS = 2500
SEED = 0
SPAWN = (0.0, 0.0, 1.2)
PILLAR = ((25.0, 12.0, 3.0), 3.0)  # example 07: centre, radius
TAXIS_GAIN = 8.0
TAXIS_CONTROL_STEPS = 10
PHYSICS_PER_CONTROL = 20
CPG_STEPS = 40
REPLAY_STEPS = {"condim1_fly": 4, "condim4_fly": 4, "condim6_fly": 20, "softweld_fly": 20,
                "pgs_fly": 20}
ENGINE_ONLY = ("softweld_fly", "pgs_fly")
ENGINE_ONLY_SETTLE = 1000
TETHER_SPAWN = (0.0, 0.0, 3.0)
WORLDS = ("taxis_fly", "cpg_fly", "condim1_fly", "condim4_fly", "condim6_fly", "softweld_fly",
          "pgs_fly")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark_fly(world, spawn_position=SPAWN, **add_fly_kwargs):
    """The benchmark fly of ``flygym_tpu/demo/benchmark.py:make_model`` (its
    default options) added to ``world``: ``(fly, world)``."""
    from flygym_tpu.anatomy import ActuatedDOFPreset, AxisOrder, JointPreset, Skeleton
    from flygym_tpu.compose import ActuatorType, Fly, KinematicPosePreset
    from flygym_tpu.utils.math import Rotation3D

    fly = Fly()
    fly.add_joints(Skeleton(axis_order=AxisOrder.YAW_PITCH_ROLL,
                            joint_preset=JointPreset.LEGS_ONLY),
                   neutral_pose=KinematicPosePreset.NEUTRAL)
    actuated = fly.skeleton.get_actuated_dofs_from_preset(ActuatedDOFPreset.LEGS_ACTIVE_ONLY)
    fly.add_actuators(actuated, actuator_type=ActuatorType.POSITION, kp=50.0,
                      neutral_input=KinematicPosePreset.NEUTRAL)
    fly.add_leg_adhesion()
    fly.colorize()
    fly.add_tracking_camera()
    world.add_fly(fly, spawn_position, Rotation3D("quat", (1, 0, 0, 0)), **add_fly_kwargs)
    return fly, world


def build_world(name: str):
    """``(fly, world)`` of the named world."""
    from flygym_tpu.compose import FlatGroundWorld, TetheredWorld
    from flygym_tpu.compose.physics import ContactParams

    if name == "softweld_fly":
        return benchmark_fly(TetheredWorld(weld="soft"), spawn_position=TETHER_SPAWN)
    if name == "pgs_fly":
        fly, world = benchmark_fly(FlatGroundWorld(), spawn_position=(0, 0, 0.8))
        world.spec.options["solver"] = "pgs"
        return fly, world
    if name.startswith("condim"):
        condim = int(name[len("condim")])
        return benchmark_fly(FlatGroundWorld(), spawn_position=(0, 0, 0.8),
                             ground_contact_params=ContactParams(condim=condim))
    fly, world = benchmark_fly(FlatGroundWorld())
    if name == "taxis_fly":
        centre, radius = PILLAR
        world.add_object("pillar", centre, radius=radius)
    return fly, world


def flatten(model, state) -> tuple:
    """A compiled JAX model and its one-world state as the port's
    ``(arrays, meta)`` (``scripts/export_torch_model.py:export`` without a
    simulation: no fly maps), for worlds compiled from a ``ModelSpec``."""
    from flygym_tpu.engine.model import PhysicsModel, State

    arrays, static = {}, {}
    for f in dataclasses.fields(PhysicsModel):
        value = getattr(model, f.name)
        if f.metadata.get("static"):
            static[f.name] = value
        else:
            arrays[f"model.{f.name}"] = np.asarray(value)
    for f in dataclasses.fields(State):
        arrays[f"state.{f.name}"] = np.asarray(getattr(state, f.name))
    return arrays, {"model": json.loads(json.dumps(static)), "flies": {}}


def eye_bodies(world, fly) -> list:
    ids = world.compiled.body_name2id
    return [int(ids[f"{fly.name}/l_eye"]), int(ids[f"{fly.name}/r_eye"])]


def settled_state(bsim, fly, settle_steps=SETTLE_STEPS):
    """``settle_steps`` vmapped engine steps from the spawn at the neutral
    targets with adhesion on (where the world has a ground)."""
    import jax

    from flygym_tpu.engine.step import step

    if bsim.model.ncand:
        bsim.set_leg_adhesion_states(fly.name, np.ones((bsim.n_worlds, 6), np.float32))
    st = bsim.state
    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0)))
    for _ in range(settle_steps):
        st = vstep(bsim.model, st)
    return st


def make_cpg(fly, timestep):
    from flygym_tpu.compose import ActuatorType
    from flygym_tpu.control import CPGController, extract_preprogrammed_steps
    from flygym_tpu.demo import MotionSnippet

    steps = extract_preprogrammed_steps(
        MotionSnippet(), fly.get_actuated_jointdofs_order(ActuatorType.POSITION))
    return CPGController(steps, timestep=timestep)


def cpg_states(n_worlds):
    """World i's controller seeded with i, stacked."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.control import CPGState

    return jax.tree.map(lambda *x: jnp.stack(x), *[CPGState.init(i) for i in range(n_worlds)])


class _Emitter:
    """The JAX emitter stepped eagerly on (B,) arrays, carrying a State."""

    def __init__(self, model):
        from flygym_tpu.ops import megastep

        self.model = model
        self.jst = megastep._Static(model)
        self.emit_step = megastep.emit_step

    def __call__(self, st):
        import jax.numpy as jnp

        from flygym_tpu.engine.model import State

        cols = lambda x: [jnp.asarray(np.asarray(x)[:, i]) for i in range(np.asarray(x).shape[1])]
        pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
        rows = lambda vecs, width: (
            np.stack([pack(p) for p in vecs], axis=1) if vecs
            else np.zeros((st.qpos.shape[0], 0, width), np.float32))
        r = self.emit_step(self.jst, cols(st.qpos), cols(st.qvel), cols(st.ctrl), cols(st.act),
                           cols(st.qacc))
        return State(
            qpos=jnp.asarray(pack(r["qpos"])), qvel=jnp.asarray(pack(r["qvel"])), ctrl=st.ctrl,
            act=jnp.asarray(pack(r["act"])) if r["act"] else st.act,
            time=st.time + self.model.timestep, qacc=jnp.asarray(pack(r["qacc"])),
            xpos=jnp.asarray(rows(r["xpos"], 3)), xquat=jnp.asarray(rows(r["xquat"], 4)),
            site_xpos=jnp.asarray(rows(r["site_xpos"], 3)),
            actuator_force=jnp.asarray(pack(r["actuator_force"])),
            contact_sensordata=jnp.asarray(rows(r["sensordata"], 16)),
        )


def _engine(model):
    import jax

    from flygym_tpu.engine.step import step

    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0)))
    return lambda st: vstep(model, st)


def _set_ctrl(st, act_ids, adh_ids, targets, adhesion):
    ctrl = st.ctrl.at[:, act_ids].set(targets).at[:, adh_ids].set(adhesion)
    return dataclasses.replace(st, ctrl=ctrl)


def taxis_loop(model, st, cs, cpg, retina, act_ids, adh_ids, physics, name) -> dict:
    """Example 07's loop over the batch, the controller and the drive
    eager; ``physics`` steps the batch once."""
    import jax

    from flygym_tpu.control.taxis import object_azimuth_drive

    render = jax.vmap(lambda s: retina.render(model, s))
    drive_of = jax.vmap(lambda v: object_azimuth_drive(v, TAXIS_GAIN))
    vcpg = jax.vmap(lambda c, d: cpg(c, drive=d))
    rec = {"vision": [], "drive": [], "phase": [], "qpos": [], "qvel": [], "xpos": [],
           "xquat": []}
    for t in range(TAXIS_CONTROL_STEPS):
        t0 = time.perf_counter()
        vision = render(st)
        drive = drive_of(vision)
        cs, targets, adhesion = vcpg(cs, drive)
        st = _set_ctrl(st, act_ids, adh_ids, targets, adhesion)
        for _ in range(PHYSICS_PER_CONTROL):
            st = physics(st)
        for key, value in (("vision", vision), ("drive", drive), ("phase", cs.phase),
                           ("qpos", st.qpos), ("qvel", st.qvel), ("xpos", st.xpos),
                           ("xquat", st.xquat)):
            rec[key].append(np.asarray(value))
        print(f"{name} control step {t + 1}/{TAXIS_CONTROL_STEPS} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {f"{name}.{k}": np.stack(v) for k, v in rec.items()}


def cpg_loop(st, cs, cpg, act_ids, adh_ids, physics, name) -> dict:
    """Example 04's loop over the batch: one CPG step at drive 1.0 and one
    physics step per step, the controller eager."""
    import jax

    vcpg = jax.vmap(lambda c: cpg(c, drive=1.0))
    rec = {"phase": [], "qpos": [], "qvel": []}
    for _ in range(CPG_STEPS):
        cs, targets, adhesion = vcpg(cs)
        st = physics(_set_ctrl(st, act_ids, adh_ids, targets, adhesion))
        for key, value in (("phase", cs.phase), ("qpos", st.qpos), ("qvel", st.qvel)):
            rec[key].append(np.asarray(value))
    return {f"{name}.{k}": np.stack(v) for k, v in rec.items()}


def replay_loop(st, ctrl, physics, name) -> dict:
    import jax.numpy as jnp

    rec = {"qpos": [], "qvel": [], "act": [], "sensordata": []}
    for c in ctrl:
        st = physics(dataclasses.replace(st, ctrl=jnp.asarray(c)))
        for key, value in (("qpos", st.qpos), ("qvel", st.qvel), ("act", st.act),
                           ("sensordata", st.contact_sensordata)):
            rec[key].append(np.asarray(value))
    return {f"{name}.{k}": np.stack(v) for k, v in rec.items()}


def replay_controls(bsim, fly, n_steps) -> np.ndarray:
    """(n_steps, B, nu) controls: the Spotlight replay's targets, adhesion on."""
    from flygym_tpu.compose import ActuatorType
    from flygym_tpu.demo.benchmark import ReplayTargetData

    ctrl0 = np.asarray(bsim.state.ctrl, np.float32)
    ctrl = np.broadcast_to(ctrl0, (n_steps,) + ctrl0.shape).copy()
    if bsim.model.ncand:
        ctrl[..., np.asarray(bsim._adh_ids[fly.name])] = 1.0
    order = fly.get_actuated_jointdofs_order(ActuatorType.POSITION)
    targets = ReplayTargetData(bsim.model.timestep, order).make_target_angles_all_worlds(
        bsim.n_worlds, n_steps)
    ctrl[..., np.asarray(bsim._act_ids_by_type[ActuatorType.POSITION][fly.name])] = (
        targets.transpose(1, 0, 2))
    return ctrl


def export_world(name: str) -> None:
    import jax.numpy as jnp

    import flygym_tpu
    from flygym_tpu.batch import BatchSimulation
    from flygym_tpu.compose import ActuatorType
    from flygym_tpu.engine.model import State
    from flygym_tpu.vision import Retina

    exporter = _load("export_torch_model")
    model_path, golden_path = ASSETS / f"{name}.npz", ASSETS / f"{name}_golden.npz"
    fly, world = build_world(name)
    sim = flygym_tpu.Simulation(world)
    arrays, meta = exporter.export(world, sim)
    if name == "taxis_fly":
        meta["flies"][fly.name]["eye_bodies"] = eye_bodies(world, fly)
    exporter.save_npz(model_path, arrays, meta)
    print(f"wrote {model_path} ({model_path.stat().st_size} bytes)", flush=True)

    bsim = BatchSimulation(world, GOLDEN_WORLDS)
    model = bsim.model
    t0 = time.perf_counter()
    settle = ENGINE_ONLY_SETTLE if name in ENGINE_ONLY else SETTLE_STEPS
    settled = settled_state(bsim, fly, settle)
    print(f"{name}: settled {settle} steps in {time.perf_counter() - t0:.1f} s; root z "
          f"{np.asarray(settled.qpos)[:, 2].round(4).tolist()}", flush=True)
    golden = {f"state.{f.name}": np.asarray(getattr(settled, f.name))
              for f in dataclasses.fields(State)}
    gmeta = {"n_worlds": GOLDEN_WORLDS, "settle_steps": settle, "seed": SEED}
    paths = (("engine", _engine(model), settled), ("emitter", _Emitter(model), settled))
    act_ids = jnp.asarray(bsim._act_ids_by_type[ActuatorType.POSITION][fly.name])
    adh_ids = jnp.asarray(bsim._adh_ids[fly.name])
    if name in REPLAY_STEPS:
        ctrl = replay_controls(bsim, fly, REPLAY_STEPS[name])
        golden["ctrl"] = ctrl
        for path, physics, start in paths[:1] if name in ENGINE_ONLY else paths:
            golden.update(replay_loop(start, ctrl, physics, path))
        gmeta["n_steps"] = REPLAY_STEPS[name]
    else:
        cpg = make_cpg(fly, bsim.timestep)
        cs0 = cpg_states(GOLDEN_WORLDS)
        for key in ("phase", "amplitude", "damplitude"):
            golden[f"controller.{key}"] = np.asarray(getattr(cs0, key))
        twofly = _load("export_twofly_golden")
        for path, physics, start in paths + (("probe", paths[0][1], twofly.perturbed(settled)),):
            if name == "taxis_fly":
                retina = Retina.for_fly(world, fly.name)
                golden.update(taxis_loop(model, start, cs0, cpg, retina, act_ids, adh_ids,
                                         physics, path))
            else:
                golden.update(cpg_loop(start, cs0, cpg, act_ids, adh_ids, physics, path))
        gmeta.update(n_steps=TAXIS_CONTROL_STEPS if name == "taxis_fly" else CPG_STEPS,
                     physics_per_control=PHYSICS_PER_CONTROL, gain=TAXIS_GAIN,
                     probe_eps=twofly.PROBE_EPS)
    exporter.save_npz(golden_path, golden, gmeta)
    print(f"wrote {golden_path} ({golden_path.stat().st_size} bytes)", flush=True)


def main():
    # The goldens are taken on the CPU backend (full fp32 matmuls).
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["FLYGYM_TPU_MEGASTEP"] = "0"
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in sys.argv[1:] or WORLDS:
        export_world(name)


if __name__ == "__main__":
    main()
