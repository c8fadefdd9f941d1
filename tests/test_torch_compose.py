"""The port's composition layer on the CPU: anatomy, poses, contact
parameters, ``Fly`` and the worlds (``tests/core/test_anatomy.py``,
``test_pose.py``, ``test_physics_params.py`` and ``test_compose.py`` on the
port), held against the JAX package where the two must agree (the DoF
orders, the neutral poses, the blocks terrain's heights).

A subprocess with ``jax``, ``jaxlib``, ``flygym_tpu`` and ``yaml`` blocked
composes, compiles and steps worlds, so the layer needs none of them.
``tests/test_torch_compile.py`` holds the compiles against the JAX
package's.
"""

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch.anatomy import (
    ALL_CONNECTED_SEGMENT_PAIRS,
    ALL_SEGMENT_NAMES,
    ANTENNA_LINKS,
    LEG_LINKS,
    LEGS,
    PASSIVE_TARSAL_LINKS,
    SIDES,
    ActuatedDOFPreset,
    AnatomicalJoint,
    AxesSet,
    AxisOrder,
    BodySegment,
    ContactBodiesPreset,
    JointDOF,
    JointPreset,
    RotationAxis,
    Skeleton,
)
from flygym_tpu_torch.compose import (
    ActuatorType,
    ContactParams,
    FlatGroundWorld,
    Fly,
    KinematicPose,
    KinematicPosePreset,
    TetheredWorld,
)
from flygym_tpu_torch.demo.worlds import build_world
from flygym_tpu_torch.utils.math import Rotation3D

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------------------
# anatomy (tests/core/test_anatomy.py on the port)
# ---------------------------------------------------------------------------


def test_anatomy_constants():
    assert len(ALL_SEGMENT_NAMES) == 69 and len(set(ALL_SEGMENT_NAMES)) == 69
    assert len(ALL_CONNECTED_SEGMENT_PAIRS) == 68
    assert LEGS == ["lf", "lm", "lh", "rf", "rm", "rh"] and SIDES == ["l", "r"]
    assert LEG_LINKS[0] == "coxa" and LEG_LINKS[-1] == "tarsus5"
    assert PASSIVE_TARSAL_LINKS == ["tarsus2", "tarsus3", "tarsus4", "tarsus5"]
    assert ANTENNA_LINKS == ["pedicel", "funiculus", "arista"]
    assert all(f"{leg}_{link}" in ALL_SEGMENT_NAMES for leg in LEGS for link in LEG_LINKS)


def test_anatomy_constants_equal_the_jax_package():
    import flygym_tpu.anatomy as jax_anatomy

    for name in ("ALL_CONNECTED_SEGMENT_PAIRS", "ALL_SEGMENT_NAMES", "LEG_LINKS",
                 "ANTENNA_LINKS", "PROBOSCIS_LINKS", "ABDOMEN_LINKS", "BODY_POSITIONS"):
        assert getattr(jax_anatomy, name) == getattr(sys.modules["flygym_tpu_torch.anatomy"],
                                                     name), name


@pytest.mark.parametrize("alias, axis", [
    ("p", RotationAxis.PITCH), ("R", RotationAxis.ROLL), ("yaw", RotationAxis.YAW),
    (RotationAxis.PITCH, RotationAxis.PITCH)])
def test_rotation_axis_aliases(alias, axis):
    assert RotationAxis(alias) is axis


@pytest.mark.parametrize("axis, vector, letter", [
    (RotationAxis.PITCH, (0, 1, 0), "y"), (RotationAxis.ROLL, (0, 0, 1), "z"),
    (RotationAxis.YAW, (1, 0, 0), "x")])
def test_rotation_axis_vector_and_letter(axis, vector, letter):
    assert axis.to_vector() == vector and axis.to_letter_xyz() == letter


def test_invalid_names_raise():
    with pytest.raises(ValueError):
        RotationAxis("q")
    with pytest.raises(ValueError):
        BodySegment("c_femur")
    with pytest.raises(ValueError):
        JointDOF.from_name("not-a-joint")


def test_axes_set_coerces_strings():
    s = AxesSet(["p", "roll"])
    assert RotationAxis.PITCH in s and RotationAxis.ROLL in s
    s.add("y")
    s.remove("pitch")
    assert RotationAxis.YAW in s and RotationAxis.PITCH not in s


@pytest.mark.parametrize("spelling", ["ypr", "yaw_pitch_roll", ("yaw", "pitch", "roll")])
def test_axis_order_spellings(spelling):
    order = AxisOrder(list(spelling) if isinstance(spelling, tuple) else spelling)
    assert order is AxisOrder.YAW_PITCH_ROLL is AxisOrder.YPR
    assert order.to_letters_xyz() == "xyz" and order.to_str() == "yaw_pitch_roll"


def test_body_segment_predicates():
    seg = BodySegment("lf_tibia")
    assert seg.pos == "lf" and seg.link == "tibia" and seg.is_leg()
    assert BodySegment("c_thorax").is_thorax() and BodySegment("c_head").is_head()
    assert BodySegment("l_eye").is_eye() and BodySegment("r_wing").is_wing()
    assert BodySegment("l_haltere").is_haltere() and BodySegment("c_abdomen3").is_abdomen()
    assert BodySegment("c_rostrum").is_proboscis() and BodySegment("l_funiculus").is_antenna()


def test_joint_dof_and_anatomical_joint():
    dof = JointDOF("c_thorax", "lf_coxa", "pitch")
    assert dof.name == "c_thorax-lf_coxa-pitch" and JointDOF.from_name(dof.name) == dof
    joint = AnatomicalJoint("c_thorax", "lf_coxa", ["pitch", "yaw"])
    assert [d.axis for d in joint.iter_dofs(AxisOrder.YPR)] == [RotationAxis.YAW,
                                                               RotationAxis.PITCH]
    assert len(AnatomicalJoint("c_thorax", "lf_coxa").axes) == 3


@pytest.mark.parametrize("preset, n_dofs", [
    (JointPreset.ALL_POSSIBLE, 204), (JointPreset.ALL_BIOLOGICAL, 126),
    (JointPreset.LEGS_ONLY, 66), (JointPreset.LEGS_ACTIVE_ONLY, 42)])
def test_joint_preset_dof_counts(preset, n_dofs):
    assert sum(len(j.axes) for j in preset.to_joint_list()) == n_dofs
    assert len(list(Skeleton(axis_order="ypr", joint_preset=preset).iter_jointdofs())) == n_dofs


@pytest.mark.parametrize("preset, n", [
    (ActuatedDOFPreset.ALL, 66), (ActuatedDOFPreset.LEGS_ONLY, 66),
    (ActuatedDOFPreset.LEGS_ACTIVE_ONLY, 42)])
def test_actuated_dof_preset_filters(preset, n):
    sk = Skeleton(axis_order="ypr", joint_preset=JointPreset.LEGS_ONLY)
    assert len(preset.filter(list(sk.iter_jointdofs()))) == n


@pytest.mark.parametrize("preset, n", [
    (ContactBodiesPreset.ALL, 69), (ContactBodiesPreset.LEGS_ONLY, 48),
    (ContactBodiesPreset.TIBIA_TARSUS_ONLY, 36),
    (ContactBodiesPreset.LEGS_THORAX_ABDOMEN_HEAD, 55)])
def test_contact_bodies_preset_counts(preset, n):
    assert len(preset.to_body_segments_list()) == n


@pytest.mark.parametrize("preset", list(JointPreset))
@pytest.mark.parametrize("order", ["ypr", "pry", "rpy"])
def test_skeleton_dof_order_equals_the_jax_package(preset, order):
    """The canonical DoF order (the contract of every readout and input)."""
    from flygym_tpu.anatomy import Skeleton as JaxSkeleton

    port = [d.name for d in Skeleton(axis_order=order, joint_preset=preset.value)
            .iter_jointdofs()]
    jax = [d.name for d in JaxSkeleton(axis_order=order, joint_preset=preset.value)
           .iter_jointdofs()]
    assert port == jax


def test_skeleton_validation():
    with pytest.raises(ValueError):
        Skeleton(axis_order="ypr")
    with pytest.raises(ValueError):
        Skeleton(axis_order="ypr", joint_preset="legs_only",
                 anatomical_joints=[AnatomicalJoint("c_thorax", "lf_coxa")])
    sk = Skeleton(axis_order="ypr", anatomical_joints=[
        AnatomicalJoint("c_thorax", "lf_coxa"), AnatomicalJoint("lm_tibia", "lm_tarsus1")])
    with pytest.raises(ValueError):
        sk.get_tree()


# ---------------------------------------------------------------------------
# poses and contact parameters (tests/core/test_pose.py,
# test_physics_params.py on the port)
# ---------------------------------------------------------------------------


def test_pose_from_dict_mirrors_without_overwriting():
    pose = KinematicPose(joint_angles_rad_dict={"c_thorax-lf_coxa-pitch": 0.3,
                                                "c_thorax-rm_coxa-pitch": 0.9,
                                                "lm_coxa-lm_trochanterfemur-roll": -0.2},
                         axis_order="ypr")
    angles = pose.joint_angles_lookup_rad
    assert angles["c_thorax-rf_coxa-pitch"] == 0.3
    assert angles["c_thorax-rm_coxa-pitch"] == 0.9
    assert angles["rm_coxa-rm_trochanterfemur-roll"] == -0.2
    clone = pose.copy()
    clone.joint_angles_lookup_rad["c_thorax-lf_coxa-pitch"] = 1.0
    assert pose.joint_angles_lookup_rad["c_thorax-lf_coxa-pitch"] == 0.3
    with pytest.raises(ValueError):
        KinematicPose()
    with pytest.raises(ValueError):
        KinematicPose(joint_angles_rad_dict={})


@pytest.mark.parametrize("order", ["pry", "pyr", "rpy", "ryp", "ypr", "yrp"])
def test_neutral_pose_equals_the_jax_package(order):
    from flygym_tpu.anatomy import AxisOrder as JaxAxisOrder
    from flygym_tpu.compose.pose import KinematicPosePreset as JaxPreset

    port = KinematicPosePreset.NEUTRAL.get_pose_by_axis_order(AxisOrder(order))
    jax = JaxPreset.NEUTRAL.get_pose_by_axis_order(JaxAxisOrder(order))
    assert port.joint_angles_lookup_rad == jax.joint_angles_lookup_rad
    assert port.axis_order.to_str() == jax.axis_order.to_str()
    assert all(abs(a) < math.pi for a in port.joint_angles_lookup_rad.values())


@pytest.mark.parametrize("text, error", [
    ({"angle_unit": "turns", "axis_order": ["y", "p", "r"], "joint_angles": {}}, ValueError),
    ({"angle_unit": "radian", "axis_order": ["y", "p", "r"],
      "joint_angles": {"c_thorax-lf_coxa-pitch": "abc"}}, ValueError),
    ({"angle_unit": "radian", "axis_order": "nope", "joint_angles": {}}, ValueError)])
def test_bad_pose_files_raise(tmp_path, text, error):
    path = tmp_path / "pose.json"
    path.write_text(json.dumps(text))
    with pytest.raises(error):
        KinematicPose(path=path)


def test_json_pose_in_degrees(tmp_path):
    path = tmp_path / "pose.json"
    path.write_text(json.dumps({"angle_unit": "degree", "axis_order": ["yaw", "pitch", "roll"],
                                "joint_angles": {"c_thorax-lf_coxa-pitch": 90}}))
    pose = KinematicPose(path=path, mirror_left2right=False)
    assert pose.joint_angles_lookup_rad["c_thorax-lf_coxa-pitch"] == pytest.approx(math.pi / 2)
    with pytest.raises(ValueError):
        KinematicPose(path=path, axis_order="ypr")


def test_yaml_pose_needs_pyyaml_only_when_read(tmp_path, monkeypatch):
    path = tmp_path / "pose.yaml"
    path.write_text("angle_unit: degree\naxis_order: [yaw, pitch, roll]\n"
                    "joint_angles:\n  c_thorax-lf_coxa-pitch: 90\n")
    pose = KinematicPose(path=path, mirror_left2right=False)
    assert pose.joint_angles_lookup_rad["c_thorax-lf_coxa-pitch"] == pytest.approx(math.pi / 2)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="pyyaml"):
        KinematicPose(path=path)
    assert KinematicPosePreset.NEUTRAL.get_pose_by_axis_order(AxisOrder.YPR)


def test_contact_params_tuples():
    p = ContactParams(sliding_friction=2.0)
    assert p.get_friction_tuple() == (2.0, 2.0, 2e-2, 1e-4, 1e-4)
    assert p.get_solref_tuple() == (2e-4, 1.0)
    assert p.get_solimp_tuple() == (0.98, 0.99, 0.5, 3.0)
    assert p.get_solimp_full_tuple() == (0.98, 0.99, 1e-5, 0.5, 3.0)
    assert ContactParams().is_valid()


@pytest.mark.parametrize("field, value", [
    ("sliding_friction", -1.0), ("solver_refaccl_timeconst", 0.0),
    ("solver_impedance_min", 1.0), ("solver_impedance_max", 1.5),
    ("solver_impedance_min2max_width", 0.0), ("solver_impedance_transitionsharpness", 0.5)])
def test_invalid_contact_params_raise(field, value):
    p = dataclasses.replace(ContactParams(), **{field: value})
    with pytest.raises(ValueError):
        p.is_valid()
    assert p.is_valid(raise_on_invalid=False) is False


# ---------------------------------------------------------------------------
# Fly and worlds (tests/core/test_compose.py on the port)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fly_world():
    fly = Fly(name="testfly")
    fly.add_joints(Skeleton(axis_order=AxisOrder.YPR, joint_preset=JointPreset.LEGS_ONLY),
                   neutral_pose=KinematicPosePreset.NEUTRAL)
    fly.add_actuators(fly.skeleton.get_actuated_dofs_from_preset("legs_active_only"),
                      ActuatorType.POSITION, kp=50.0, neutral_input=KinematicPosePreset.NEUTRAL)
    fly.add_leg_adhesion()
    fly.add_joint_sites(fly.skeleton.anatomical_joints)
    fly.colorize()
    fly.add_tracking_camera()
    world = FlatGroundWorld()
    world.add_fly(fly, (0, 0, 2.0), Rotation3D("quat", (1, 0, 0, 0)))
    model, state = world.compile()
    return fly, world, model, state


def test_fly_composition(fly_world):
    fly, _world, _model, _state = fly_world
    assert len(fly.bodyseg_to_specbody) == 69 and len(fly.jointdof_to_specjoint) == 66
    assert len(fly.get_actuated_jointdofs_order(ActuatorType.POSITION)) == 42
    assert len(fly.get_sites_order()) == 48
    assert all(a.ctrlrange == (1.0, 100.0) for a in fly.leg_to_adhesionactuator.values())
    joints = {d.name: j for d, j in fly.jointdof_to_specjoint.items()}
    assert np.allclose(joints["c_thorax-lf_coxa-roll"].axis,
                       -np.asarray(joints["c_thorax-rf_coxa-roll"].axis))
    with pytest.raises(ValueError):
        fly.add_leg_adhesion()
    with pytest.raises(ValueError):
        fly.add_joint_sites([AnatomicalJoint("c_thorax", "lf_coxa")])


def test_world_composition_and_compile(fly_world):
    fly, world, model, state = fly_world
    assert world.fly_lookup["testfly"] is fly
    assert world.world_dof_neutral_states["testfly/testfly"] == [0, 0, 2.0, 1, 0, 0, 0]
    assert set(world.legpos_to_groundcontactsensors_by_fly["testfly"]) == set(LEGS)
    with pytest.raises(ValueError):
        world.add_fly(fly, (0, 0, 0), Rotation3D("quat", (1, 0, 0, 0)))
    with pytest.raises(ValueError):
        FlatGroundWorld().add_fly(Fly(name="f2"), (0, 0, 0), Rotation3D("euler", (0, 0, 0)))
    assert (model.nbody, model.nhinge, model.nq, model.nv, model.nu) == (70, 66, 73, 72, 48)
    assert model.ncand == 110 and model.nsensor_contact == 6 and model.nsite == 48
    assert state.qpos.shape == (1, 73) and torch.equal(state.qpos[0], model.qpos0)
    assert 0.5e-3 < float(model.body_mass.sum()) < 2e-3
    compiled = world.compiled
    assert "testfly/c_thorax" in compiled.body_name2id
    assert "testfly/c_thorax-lf_coxa-yaw" in compiled.hinge_name2id
    assert compiled.fly_names == ["testfly"] and len(compiled.flies["testfly"]["site_ids"]) == 48
    assert [c["full_identifier"] for c in compiled.render["cameras"]] == ["testfly/trackcam"]


@pytest.mark.parametrize("preset, n_cand", [
    (ContactBodiesPreset.TIBIA_TARSUS_ONLY, 72), (ContactBodiesPreset.LEGS_ONLY, 96)])
def test_contact_presets_and_params_flow_through(preset, n_cand):
    fly = Fly(name="f3")
    fly.add_joints(Skeleton(axis_order="ypr", joint_preset="legs_only"),
                   neutral_pose=KinematicPosePreset.NEUTRAL)
    world = FlatGroundWorld()
    world.add_fly(fly, (0, 0, 2), Rotation3D("quat", (1, 0, 0, 0)),
                  bodysegs_with_ground_contact=preset,
                  ground_contact_params=ContactParams(sliding_friction=2.5, margin=4e-3))
    model, _ = world.compile()
    assert model.ncand == n_cand
    assert torch.allclose(model.can_friction[:, 0], torch.tensor(2.5))
    assert torch.allclose(model.can_margin, torch.tensor(4e-3))


def test_tethered_world_fixes_the_root():
    fly = Fly(name="f5")
    fly.add_joints(Skeleton(axis_order="ypr", joint_preset="legs_only"),
                   neutral_pose=KinematicPosePreset.NEUTRAL)
    world = TetheredWorld()
    world.add_fly(fly, (1, 2, 3), Rotation3D("quat", (1, 0, 0, 0)))
    model, state = world.compile()
    assert model.nq == 66 and model.nv == 66 and not model.free_joints
    root = world.compiled.body_name2id["f5/c_thorax"]
    assert torch.allclose(state.xpos[0, root], torch.tensor([1.0, 2.0, 3.0]))
    with pytest.raises(ValueError):
        TetheredWorld(weld="rubber")


def test_fly_fly_contacts_need_two_attached_flies():
    world = FlatGroundWorld()
    a, b = Fly(name="a"), Fly(name="b")
    world.add_fly(a, (0, 0, 1), Rotation3D("quat", (1, 0, 0, 0)))
    with pytest.raises(ValueError):
        world.add_fly_fly_contacts(a, b)
    with pytest.raises(ValueError):
        world.add_fly_fly_contacts(a, a)
    world.add_fly(b, (0, 0, 3), Rotation3D("quat", (1, 0, 0, 0)))
    assert world.add_all_fly_fly_contacts(bodysegs=[BodySegment("c_thorax")]) == 1


# ---------------------------------------------------------------------------
# without JAX, the JAX package or PyYAML
# ---------------------------------------------------------------------------


def test_the_compose_layer_runs_without_jax_or_yaml():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flygym_tpu', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import flygym_tpu_torch as ft\n"
        "from flygym_tpu_torch.demo.benchmark import make_model\n"
        "from flygym_tpu_torch.demo.worlds import build_world\n"
        "from flygym_tpu_torch.compose import FlatGroundWorld, Fly, KinematicPosePreset\n"
        "from flygym_tpu_torch.anatomy import Skeleton\n"
        "from flygym_tpu_torch.utils.math import Rotation3D\n"
        "fly, world, cam = make_model(trim_contacts=True)\n"
        "flat = FlatGroundWorld()\n"
        "f = Fly(name='f')\n"
        "f.add_joints(Skeleton(axis_order='ypr', joint_preset='legs_only'),\n"
        "             neutral_pose=KinematicPosePreset.NEUTRAL)\n"
        "f.add_leg_adhesion()\n"
        "flat.add_fly(f, (0, 0, 1.2), Rotation3D('quat', (1, 0, 0, 0)))\n"
        "worlds = [world, flat, build_world('tethered_fly')[1], build_world('terrain_fly')[1]]\n"
        "for w in worlds:\n"
        "    sim = ft.BatchSimulation(w, 2, device='cpu')\n"
        "    sim.rollout(None, 2, record_trajectory=False)\n"
        "    assert np.isfinite(sim.state.qpos.numpy()).all()\n"
        "    assert w.compiled.model.nv == sim.model.nv\n"
        "print('xml', len(world.spec.to_mjcf_xml()))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flygym_tpu', 'yaml')\n"
        "       and sys.modules[m] is not None]\n"
        "files = [getattr(m, '__file__', None) or '' for m in list(sys.modules.values()) if m]\n"
        "outside = [p for p in files if '/flygym_tpu/' in p.replace('\\\\', '/')]\n"
        "print(bad, outside)\n"
        "sys.exit(1 if bad or outside else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_port_module_reads_the_jax_package():
    """No module of the port, and not ``chip_smoke.py``, imports the JAX
    package or names a file under ``flygym_tpu/`` in its code (a
    ``file:line`` reference, as the kernels' ``replaces``, reads nothing)."""
    import re

    imports = re.compile(r"^\s*(from|import)\s+flygym_tpu(\.|\s|$)")
    offenders = []
    for path in [*sorted((REPO / "flygym_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py"]:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#")[0]
            if imports.match(code) or re.search(r"[\"']flygym_tpu/[\w/.]*[\"']", code):
                offenders.append(f"{path.relative_to(REPO)}:{i}")
    assert offenders == []


@pytest.mark.parametrize("kind", ["motor", "velocity"])
@pytest.mark.parametrize("pose", ["preset", "pose"])
def test_pose_as_input_of_other_actuators_is_refused_like_jax(kind, pose):
    """A ``KinematicPosePreset`` or ``KinematicPose`` as the neutral input of
    actuators other than position servos: the JAX package fails with an
    AttributeError (it reads the pose as a dict), the port refuses it with
    a ValueError that names the way round (``neutral_pose=None`` in
    ``make_model``); ``make_model(actuator_type=MOTOR)`` fails in both with
    its default neutral pose."""
    import flygym_tpu.compose as jc
    import flygym_tpu.demo.benchmark as jb
    from flygym_tpu.anatomy import Skeleton as JaxSkeleton

    import flygym_tpu_torch.compose as pc
    import flygym_tpu_torch.demo.benchmark as pb
    from flygym_tpu_torch.anatomy import Skeleton

    def attempt(compose, skeleton_cls):
        fly = compose.Fly(name="f")
        fly.add_joints(skeleton_cls(axis_order="ypr", joint_preset="legs_only"))
        neutral = compose.KinematicPosePreset.NEUTRAL
        if pose == "pose":
            neutral = neutral.get_pose_by_axis_order(fly.skeleton.axis_order)
        fly.add_actuators(fly.skeleton.get_actuated_dofs_from_preset("legs_active_only"),
                          compose.ActuatorType(kind), neutral_input=neutral)

    with pytest.raises(AttributeError):
        attempt(jc, JaxSkeleton)
    with pytest.raises(ValueError, match="neutral_pose=None"):
        attempt(pc, Skeleton)
    if kind == "motor" and pose == "preset":
        with pytest.raises(AttributeError):
            jb.make_model(actuator_type=jc.ActuatorType.MOTOR)
        with pytest.raises(ValueError, match="neutral_pose=None"):
            pb.make_model(actuator_type=pc.ActuatorType.MOTOR)
