"""The committed worlds, composed by the port.

Each ``.npz`` world under ``flygym_tpu_torch/assets/`` was compiled by the
JAX package in a ``scripts/export_*.py`` script. :func:`build_world` composes
the same world with the port's composition layer, from the same builder
arguments, so that its compile can be held against the file
(``tests/test_torch_compose.py``, ``chip_smoke.py`` phase 47) and so that
a user can start from the world instead of the file.

``build_world(name)`` returns ``(fly, world)`` for a one-fly world and
``(None, world)`` for the multi-fly ones (``twofly``, ``twofly_full``,
``threefly``, ``twofly_condim6``, ``twofly_terrain``). :data:`WORLDS` lists the names and, for each, the script
whose builder it repeats.
"""

from flygym_tpu_torch.anatomy import (
    ALL_SEGMENT_NAMES,
    ActuatedDOFPreset,
    AxisOrder,
    BodySegment,
    ContactBodiesPreset,
    JointPreset,
    Skeleton,
)
from flygym_tpu_torch.compose.fly import ActuatorType, Fly
from flygym_tpu_torch.compose.physics import ContactParams
from flygym_tpu_torch.compose.pose import KinematicPosePreset
from flygym_tpu_torch.compose.world import (
    BlocksTerrainWorld,
    FlatGroundWorld,
    TetheredWorld,
)
from flygym_tpu_torch.demo.benchmark import make_model
from flygym_tpu_torch.utils.math import Rotation3D

__all__ = ["WORLDS", "build_world"]

# Each world and the builder it repeats.
WORLDS = {
    "benchmark_fly": "scripts/export_torch_model.py:build_benchmark",
    "strict_fly": "scripts/export_actuator_golden.py:build_world",
    "muscle_fly": "scripts/export_actuator_golden.py:build_world",
    "mixed_fly": "scripts/export_actuator_golden.py:build_world",
    "tethered_fly": "scripts/export_actuator_golden.py:build_tethered",
    "terrain_fly": "scripts/export_terrain_golden.py:build_world",
    "twofly": "scripts/export_twofly_golden.py:build_world",
    "twofly_full": "scripts/export_compressed_golden.py:build_world",
    "twofly_condim6": "scripts/export_pair_variants_golden.py:build_world",
    "twofly_terrain": "scripts/export_pair_variants_golden.py:build_world",
    "threefly": "scripts/export_compressed_golden.py:build_world",
    "taxis_fly": "scripts/export_taxis_golden.py:build_world",
    "cpg_fly": "scripts/export_taxis_golden.py:build_world",
    "condim1_fly": "scripts/export_taxis_golden.py:build_world",
    "condim4_fly": "scripts/export_taxis_golden.py:build_world",
    "condim6_fly": "scripts/export_taxis_golden.py:build_world",
    "softweld_fly": "scripts/export_taxis_golden.py:build_world",
    "pgs_fly": "scripts/export_taxis_golden.py:build_world",
    "env_fly": "scripts/export_env_golden.py:build_env",
}

_QUAT = Rotation3D("quat", (1, 0, 0, 0))
# The mixed fly's actuator kind per leg, in the fly's leg order, with its
# add_actuators arguments (scripts/export_actuator_golden.py:MIXED_KINDS).
_MIXED_KINDS = (
    ("position", {"kp": 50.0}),
    ("motor", {"ctrlrange": (-1.0, 1.0)}),
    ("velocity", {"kv": 1.0}),
    ("intvelocity", {"kp": 50.0}),
    ("damper", {"kv": 1.0, "ctrlrange": (0.0, 1.0)}),
    ("cylinder", {"ctrlrange": (-1.0, 1.0)}),
)


def _legs_fly(name: str, joint_preset=JointPreset.LEGS_ONLY) -> Fly:
    fly = Fly(name=name)
    fly.add_joints(Skeleton(axis_order=AxisOrder.YPR, joint_preset=joint_preset),
                   neutral_pose=KinematicPosePreset.NEUTRAL)
    return fly


def _position_legs(fly: Fly) -> Fly:
    """Position actuators (kp 50, the neutral pose) on the active leg DoFs
    and leg adhesion."""
    dofs = fly.skeleton.get_actuated_dofs_from_preset(ActuatedDOFPreset.LEGS_ACTIVE_ONLY)
    fly.add_actuators(dofs, ActuatorType.POSITION, kp=50.0,
                      neutral_input=KinematicPosePreset.NEUTRAL)
    fly.add_leg_adhesion()
    return fly


def _benchmark_fly(world, spawn_position=(0.0, 0.0, 1.2), **add_fly_kwargs):
    """make_model's fly (its defaults) added to ``world``
    (``scripts/export_taxis_golden.py:benchmark_fly``)."""
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
    world.add_fly(fly, spawn_position, _QUAT, **add_fly_kwargs)
    return fly, world


def _tethered():
    fly = Fly(name="actfly")
    fly.add_joints(Skeleton(axis_order=AxisOrder.YPR, joint_preset=JointPreset.LEGS_ACTIVE_ONLY),
                   neutral_pose=KinematicPosePreset.NEUTRAL)
    fly.add_actuators(fly.skeleton.get_actuated_dofs_from_preset("all"), ActuatorType.MOTOR,
                      forcerange=(-5.0, 5.0))
    world = TetheredWorld()
    world.add_fly(fly, (0, 0, 3.0), _QUAT)
    return fly, world


def _actuator_fly(name: str):
    fly = _legs_fly("fly")
    dofs = fly.skeleton.get_actuated_dofs_from_preset(ActuatedDOFPreset.LEGS_ACTIVE_ONLY)
    if name == "muscle_fly":
        fly.add_actuators(dofs, ActuatorType.MUSCLE, lengthrange=(-1.0, 1.0),
                          forcelimited=False, forcerange=(-50, 50), ctrlrange=(0.0, 1.0))
    else:
        for leg, (kind, kwargs) in zip(fly.get_legs_order(), _MIXED_KINDS):
            leg_dofs = [d for d in dofs if d.child.pos == leg]
            extra = {"neutral_input": KinematicPosePreset.NEUTRAL} if kind == "position" else {}
            fly.add_actuators(leg_dofs, ActuatorType(kind), **extra, **kwargs)
    fly.add_leg_adhesion()
    world = FlatGroundWorld()
    world.add_fly(fly, (0, 0, 1.2), _QUAT)
    return fly, world


def _two_flies(full_pairs: bool):
    """Example 11's two stacked flies; ``full_pairs`` takes the default
    contact preset on both (55 x 55 pair rows, compressed)."""

    def mkfly(name):
        fly = _legs_fly(name)
        fly.add_leg_adhesion()
        if not full_pairs:
            fly.colorize()
            fly.add_tracking_camera()
        return fly

    world = FlatGroundWorld()
    world.add_fly(mkfly("bottom"), (0, 0, 1.2), _QUAT)
    world.add_fly(mkfly("top"), (0, 0, 3.2), _QUAT)
    if full_pairs:
        world.add_fly_fly_contacts("bottom", "top")
    else:
        segs = [s for s in ContactBodiesPreset.LEGS_THORAX_ABDOMEN_HEAD.to_body_segments_list()
                if "thorax" in s.name or "abdomen" in s.name or "head" in s.name]
        world.add_fly_fly_contacts("bottom", "top", bodysegs=segs)
    return None, world


def _three_flies():
    world = FlatGroundWorld()
    for i, name in enumerate(("a", "b", "c")):
        world.add_fly(_legs_fly(name), (0, 0, 1.2 + 1.8 * i), _QUAT)
    segs = [BodySegment("c_thorax")] + [
        BodySegment(s) for s in ALL_SEGMENT_NAMES if s.endswith("tarsus5")]
    world.add_all_fly_fly_contacts(bodysegs=segs)
    world.spec.options["pair_compress"] = True
    return None, world


def build_world(name: str):
    """``(fly, world)`` of the committed world ``name`` (a key of
    :data:`WORLDS`), composed by the port; ``fly`` is None for the
    multi-fly worlds."""
    if name == "benchmark_fly":
        fly, world, _cam = make_model()
        return fly, world
    if name == "strict_fly":
        fly, world, _cam = make_model()
        world.spec.options["solver_exact"] = True
        world.spec.options["solver_iterations"] = 10
        return fly, world
    if name in ("muscle_fly", "mixed_fly"):
        return _actuator_fly(name)
    if name == "tethered_fly":
        return _tethered()
    if name == "terrain_fly":
        fly = _position_legs(_legs_fly("rugged"))
        world = BlocksTerrainWorld(block_size=1.3, height_range=(0.2, 0.35))
        world.add_fly(fly, (0, 0, 2.0), _QUAT)
        return fly, world
    if name in ("twofly", "twofly_full"):
        return _two_flies(full_pairs=name == "twofly_full")
    if name == "threefly":
        return _three_flies()
    if name in ("twofly_condim6", "twofly_terrain"):
        from flygym_tpu_torch.demo.two_flies import make_two_fly_world

        if name == "twofly_terrain":
            return None, make_two_fly_world(terrain=True)
        return None, make_two_fly_world(condim=int(name[len("twofly_condim"):]))
    if name == "softweld_fly":
        return _benchmark_fly(TetheredWorld(weld="soft"), spawn_position=(0.0, 0.0, 3.0))
    if name == "pgs_fly":
        fly, world = _benchmark_fly(FlatGroundWorld(), spawn_position=(0, 0, 0.8))
        world.spec.options["solver"] = "pgs"
        return fly, world
    if name.startswith("condim"):
        return _benchmark_fly(FlatGroundWorld(), spawn_position=(0, 0, 0.8),
                              ground_contact_params=ContactParams(condim=int(name[6])))
    if name in ("taxis_fly", "cpg_fly"):
        fly, world = _benchmark_fly(FlatGroundWorld())
        if name == "taxis_fly":
            world.add_object("pillar", (25.0, 12.0, 3.0), radius=3.0)
        return fly, world
    if name == "env_fly":
        from flygym_tpu_torch.demo.multimodal_navigation import build_world as env_world

        return env_world()
    raise ValueError(f"unknown world {name!r}; the worlds are {sorted(WORLDS)}")
