"""Export the worlds of the mega-step's actuator and solver slices for the
PyTorch port.

Four worlds, each compiled and run by the JAX package on the CPU:

- **The strict replay's fly** (``strict_fly``): the benchmark fly of
  ``flygym_tpu/demo/benchmark.py:make_model`` with ``solver_exact`` (MuJoCo's
  exact Newton, the Hessian re-factored at every iteration) and 10 Newton
  iterations: the "strict" model of ``scripts/dev/bench_models.py``. Its
  golden replays the Spotlight clip's targets, as the benchmark golden does.
- **The muscle-driven fly** (``muscle_fly``): the LEGS_ONLY fly of
  ``tests/engine/test_megastep.py::TestEmitterMuscle`` on flat ground, its 42
  leg DoFs driven by MUSCLE actuators (length range +-1, ctrl range [0, 1],
  not force-limited) with leg adhesion; its golden holds ctrl 0.7.
- **The mixed-kind fly** (``mixed_fly``): the same fly with one actuator kind
  per leg, in the fly's leg order: position (kp 50), motor, velocity (kv 1),
  intvelocity (kp 50), damper (kv 1) and cylinder, with leg adhesion; its
  golden holds a seeded control per world inside each kind's range.
- **The tethered motor fly** (``tethered_fly``): the world of
  ``tests/engine/test_actuators_golden.py:25-38``: a ``TetheredWorld`` (a
  hard weld: the fly's root stays where it was spawned), the
  LEGS_ACTIVE_ONLY skeleton and a MOTOR actuator on every DoF with
  forcerange (-5, 5). It compiles to 42 DoFs and no contact candidate, the
  world of tethered motor-control experiments. Its golden settles under one
  seeded torque per world and DoF inside (-5, 5), then holds another.

Each is written as ``flygym_tpu_torch/assets/<name>.npz`` (as
``scripts/export_torch_model.py`` writes the benchmark fly) and
``<name>_golden.npz``: 8 worlds with adhesion on, settled through the
vmapped JAX engine step (2,500 steps for the strict fly, as the benchmark
golden; 1,000 from the drop for the others), then 50 steps recorded three
times with the same controls, ``ctrl`` (50, 8, nu):

- ``emitter.*``: the mega-step emitter (``flygym_tpu.ops.megastep.
  emit_step``) stepped eagerly on (B,) arrays;
- ``engine.*``: the vmapped engine step;
- ``probe.*``: the engine step from the settled state perturbed by 1e-5
  relative in qpos and 1e-5 absolute in qvel (the conditioning probe of
  ``scripts/export_twofly_golden.py``). The mixed fly's velocity-servo and
  damper legs ring at up to ~75 rad/s, where the JAX engine and the JAX
  emitter part by O(1) within 35 steps; a port of the engine step is held
  there to the probe's spread.

Each records per step ``qpos``, ``qvel``, ``act`` and ``sensordata``.

Run from the repository root (about 10-40 minutes on one CPU core, most of
it the eager emitter of the strict fly; one argument names one world)::

    JAX_PLATFORMS=cpu python scripts/export_actuator_golden.py [strict_fly|muscle_fly|mixed_fly|tethered_fly]
"""

import dataclasses
import importlib.util
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "flygym_tpu_torch" / "assets"

GOLDEN_WORLDS = 8
GOLDEN_STEPS = 50
SEED = 0
STRICT_ITERATIONS = 10
MUSCLE_CTRL = 0.7
# The mixed fly's kind per leg, in the fly's leg order, with its
# ``add_actuators`` arguments and the range its seeded controls are drawn
# from (each inside the actuator's ctrl range where it has one).
MIXED_KINDS = (
    ("position", {"kp": 50.0}, None),
    ("motor", {"ctrlrange": (-1.0, 1.0)}, (-0.2, 0.2)),
    ("velocity", {"kv": 1.0}, (-1.0, 1.0)),
    ("intvelocity", {"kp": 50.0}, (-1.0, 1.0)),
    ("damper", {"kv": 1.0, "ctrlrange": (0.0, 1.0)}, (0.0, 1.0)),
    ("cylinder", {"ctrlrange": (-1.0, 1.0)}, (-0.5, 0.5)),
)
POSITION_NOISE = 0.1  # rad around the neutral pose, the mixed fly's position leg
TETHER_TORQUE = 5.0  # the tethered fly's motors: forcerange and seeded torques in (-5, 5)
WORLDS = {
    "strict_fly": {"settle_steps": 2500},
    "muscle_fly": {"settle_steps": 1000},
    "mixed_fly": {"settle_steps": 1000},
    "tethered_fly": {"settle_steps": 1000},
}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _legs_fly(name: str):
    from flygym_tpu.anatomy import AxisOrder, JointPreset, Skeleton
    from flygym_tpu.compose import Fly, KinematicPosePreset

    fly = Fly(name=name)
    fly.add_joints(Skeleton(axis_order=AxisOrder.YPR, joint_preset=JointPreset.LEGS_ONLY),
                   neutral_pose=KinematicPosePreset.NEUTRAL)
    return fly


def build_tethered():
    """The tethered motor fly (``tests/engine/test_actuators_golden.py:25-38``
    with ``ActuatorType.MOTOR, forcerange=(-5, 5)``)."""
    from flygym_tpu.anatomy import AxisOrder, JointPreset, Skeleton
    from flygym_tpu.compose import ActuatorType, Fly, KinematicPosePreset, TetheredWorld
    from flygym_tpu.utils.math import Rotation3D

    fly = Fly(name="actfly")
    fly.add_joints(Skeleton(axis_order=AxisOrder.YPR, joint_preset=JointPreset.LEGS_ACTIVE_ONLY),
                   neutral_pose=KinematicPosePreset.NEUTRAL)
    dofs = fly.skeleton.get_actuated_dofs_from_preset("all")
    fly.add_actuators(dofs, ActuatorType.MOTOR, forcerange=(-TETHER_TORQUE, TETHER_TORQUE))
    world = TetheredWorld()
    world.add_fly(fly, (0, 0, 3.0), Rotation3D("quat", (1, 0, 0, 0)))
    return fly, world


def build_world(name: str):
    """``(fly, world)`` of the named world."""
    from flygym_tpu.anatomy import ActuatedDOFPreset
    from flygym_tpu.compose import ActuatorType, FlatGroundWorld, KinematicPosePreset
    from flygym_tpu.utils.math import Rotation3D

    if name == "tethered_fly":
        return build_tethered()
    if name == "strict_fly":
        from flygym_tpu.demo.benchmark import make_model

        fly, world, _cam = make_model()
        world.spec.options["solver_exact"] = True
        world.spec.options["solver_iterations"] = STRICT_ITERATIONS
        return fly, world
    fly = _legs_fly("fly")
    dofs = fly.skeleton.get_actuated_dofs_from_preset(ActuatedDOFPreset.LEGS_ACTIVE_ONLY)
    if name == "muscle_fly":
        fly.add_actuators(dofs, ActuatorType.MUSCLE, lengthrange=(-1.0, 1.0),
                          forcelimited=False, forcerange=(-50, 50), ctrlrange=(0.0, 1.0))
    else:
        legs = fly.get_legs_order()
        if len(legs) != len(MIXED_KINDS):
            raise RuntimeError(f"{len(legs)} legs for {len(MIXED_KINDS)} kinds")
        for leg, (kind, kwargs, _range) in zip(legs, MIXED_KINDS):
            leg_dofs = [d for d in dofs if d.child.pos == leg]
            extra = {"neutral_input": KinematicPosePreset.NEUTRAL} if kind == "position" else {}
            fly.add_actuators(leg_dofs, ActuatorType(kind), **extra, **kwargs)
    fly.add_leg_adhesion()
    world = FlatGroundWorld()
    world.add_fly(fly, (0, 0, 1.2), Rotation3D("quat", (1, 0, 0, 0)))
    return fly, world


def golden_controls(name: str, sim, fly, n_worlds: int, n_steps: int) -> np.ndarray:
    """(n_steps, n_worlds, nu) controls of the recorded steps: adhesion on
    throughout where the fly has it; the strict fly's position actuators
    replay the Spotlight clip; the muscles hold 0.7; the mixed fly's
    actuators hold a seeded control per world; the tethered fly's motors a
    seeded torque per world and DoF."""
    from flygym_tpu.compose.fly import ActuatorType

    ctrl0 = np.asarray(sim._initial_state.ctrl, np.float32)
    ctrl = np.broadcast_to(ctrl0, (n_steps, n_worlds, ctrl0.shape[-1])).copy()
    if fly.name in sim._adh_ids:
        ctrl[..., np.asarray(sim._adh_ids[fly.name])] = 1.0
    ids = lambda kind: np.asarray(sim._act_ids_by_type[ActuatorType(kind)][fly.name])
    if name == "tethered_fly":
        ctrl[..., ids("motor")] = tethered_torques(n_worlds, len(ids("motor")), SEED)
    elif name == "strict_fly":
        from flygym_tpu.demo.benchmark import ReplayTargetData

        order = fly.get_actuated_jointdofs_order(ActuatorType.POSITION)
        targets = ReplayTargetData(sim.model.timestep, order).make_target_angles_all_worlds(
            n_worlds, n_steps)
        ctrl[..., ids("position")] = targets.transpose(1, 0, 2)
    elif name == "muscle_fly":
        ctrl[..., ids("muscle")] = MUSCLE_CTRL
    else:
        rng = np.random.default_rng(SEED)
        for kind, _kwargs, span in MIXED_KINDS:
            a = ids(kind)
            if span is None:
                draw = ctrl0[a] + rng.uniform(-POSITION_NOISE, POSITION_NOISE, (n_worlds, len(a)))
            else:
                draw = rng.uniform(*span, (n_worlds, len(a)))
            ctrl[..., a] = draw.astype(np.float32)
    return ctrl


def tethered_torques(n_worlds: int, n: int, seed: int) -> np.ndarray:
    """(n_worlds, n) seeded torques inside the motors' forcerange."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-TETHER_TORQUE, TETHER_TORQUE, (n_worlds, n)).astype(np.float32)


def settled_state(model, state, ctrl: np.ndarray, settle_steps: int):
    """``settle_steps`` vmapped engine steps at the controls ``ctrl`` (B, nu)
    (for the strict fly: the neutral targets with adhesion on)."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine.step import step

    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0)))
    st = dataclasses.replace(state, ctrl=jnp.asarray(ctrl))
    for _ in range(settle_steps):
        st = vstep(model, st)
    return st


def engine_loop(model, st, ctrl: np.ndarray, name: str = "engine") -> dict:
    """The vmapped engine step at the controls ``ctrl`` (n_steps, B, nu),
    recorded as ``name.*``."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine.step import step

    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0)))
    rec = {"qpos": [], "qvel": [], "act": [], "sensordata": []}
    for c in ctrl:
        st = vstep(model, dataclasses.replace(st, ctrl=jnp.asarray(c)))
        for key, field in (("qpos", st.qpos), ("qvel", st.qvel), ("act", st.act),
                           ("sensordata", st.contact_sensordata)):
            rec[key].append(np.asarray(field))
    return {f"{name}.{k}": np.stack(v) for k, v in rec.items()}


def emitter_loop(model, st, ctrl: np.ndarray) -> dict:
    """The mega-step emitter stepped eagerly on (B,) arrays at the controls
    ``ctrl`` (n_steps, B, nu)."""
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep

    jst = megastep._Static(model)
    cols = lambda x: [jnp.asarray(np.asarray(x)[:, i]) for i in range(np.asarray(x).shape[1])]
    pack = lambda lst, w: (np.stack([np.asarray(x) for x in lst], axis=1) if lst
                           else np.zeros((w, 0), np.float32))
    # (B, nsensor, 16), also where the world has no contact sensor.
    sensors = lambda rows, w: (np.stack([pack(s, w) for s in rows], axis=1) if rows
                               else np.zeros((w, 0, 16), np.float32))
    B = ctrl.shape[1]
    q, v, act, warm = cols(st.qpos), cols(st.qvel), cols(st.act), cols(st.qacc)
    rec = {"qpos": [], "qvel": [], "act": [], "sensordata": []}
    for t, c in enumerate(ctrl):
        t0 = time.perf_counter()
        r = megastep.emit_step(jst, q, v, cols(c), act, warm)
        q, v, act, warm = r["qpos"], r["qvel"], r["act"], r["qacc"]
        rec["qpos"].append(pack(q, B))
        rec["qvel"].append(pack(v, B))
        rec["act"].append(pack(act, B))
        rec["sensordata"].append(sensors(r["sensordata"], B))
        print(f"emitter step {t + 1}/{len(ctrl)} in {time.perf_counter() - t0:.1f} s", flush=True)
    return {f"emitter.{k}": np.stack(v) for k, v in rec.items()}


def export_world(name: str) -> None:
    import flygym_tpu
    from flygym_tpu.batch import BatchSimulation
    from flygym_tpu.engine.model import State
    from flygym_tpu.ops import megastep

    exporter = _load("export_torch_model", REPO / "scripts" / "export_torch_model.py")
    model_path, golden_path = ASSETS / f"{name}.npz", ASSETS / f"{name}_golden.npz"
    fly, world = build_world(name)
    sim = flygym_tpu.Simulation(world)
    arrays, meta = exporter.export(world, sim)
    exporter.save_npz(model_path, arrays, meta)
    print(f"wrote {model_path} ({model_path.stat().st_size} bytes)", flush=True)

    bsim = BatchSimulation(world, GOLDEN_WORLDS)
    model = bsim.model
    if not megastep.megastep_supported(model):
        raise RuntimeError(f"{name}: the JAX package's mega-step does not take this model")
    settle = WORLDS[name]["settle_steps"]
    ctrl = golden_controls(name, sim, fly, GOLDEN_WORLDS, GOLDEN_STEPS)
    settle_ctrl = ctrl[0].copy()
    if name == "strict_fly":  # the benchmark golden settles at the neutral targets
        settle_ctrl = np.asarray(bsim.state.ctrl, np.float32).copy()
        settle_ctrl[:, np.asarray(sim._adh_ids[fly.name])] = 1.0
    elif name == "tethered_fly":  # settled under other torques than the recorded ones
        settle_ctrl[:] = tethered_torques(GOLDEN_WORLDS, settle_ctrl.shape[1], SEED + 1)
    t0 = time.perf_counter()
    settled = settled_state(model, bsim.state, settle_ctrl, settle)
    print(f"{name}: settled {settle} steps in {time.perf_counter() - t0:.1f} s; root z "
          f"{np.asarray(settled.qpos)[:, 2].round(4).tolist()}", flush=True)
    golden = {f"state.{f.name}": np.asarray(getattr(settled, f.name))
              for f in dataclasses.fields(State)}
    golden["ctrl"] = ctrl
    golden.update(engine_loop(model, settled, ctrl))
    twofly = _load("export_twofly_golden", REPO / "scripts" / "export_twofly_golden.py")
    golden.update(engine_loop(model, twofly.perturbed(settled), ctrl, "probe"))
    print(f"{name}: engine golden and probe done", flush=True)
    golden.update(emitter_loop(model, settled, ctrl))
    gmeta = {"n_worlds": GOLDEN_WORLDS, "settle_steps": settle, "n_steps": GOLDEN_STEPS,
             "seed": SEED, "probe_eps": twofly.PROBE_EPS}
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
