"""Example 01: building a fly model.

``main`` is ``examples/01_build_a_fly.py`` in torch: compose a fly from
presets (the LEGS_ONLY skeleton, position servos on the active leg DoFs, leg
adhesion, joint sites, colours and a tracking camera), put it on flat
ground, compile, print the model's sizes and the first joint DoFs, export
the world as MJCF, then settle it (``warmup``, 500 steps) and print which
legs touch the ground. On the card the settle is 500 K = 1 launches of the
mega-step kernel K2; on the CPU it is the engine step.

Run (``--device cpu`` on a machine without a card)::

    python -m flygym_tpu_torch.demo.build_a_fly [--device cpu] [--out PATH]
"""

import argparse
from pathlib import Path

import numpy as np

from flygym_tpu_torch.anatomy import ActuatedDOFPreset, AxisOrder, JointPreset, Skeleton
from flygym_tpu_torch.compose.fly import ActuatorType, Fly
from flygym_tpu_torch.compose.pose import KinematicPosePreset
from flygym_tpu_torch.compose.world import FlatGroundWorld
from flygym_tpu_torch.simulation import Simulation
from flygym_tpu_torch.utils.math import Rotation3D

__all__ = ["build_fly_world", "main"]


def build_fly_world():
    """Example 01's fly "fly0" at (0, 0, 2) on flat ground: ``(fly, world)``."""
    # 1. A fly is a body tree (69 segments) and joints chosen by preset.
    fly = Fly(name="fly0")
    skeleton = Skeleton(axis_order=AxisOrder.YAW_PITCH_ROLL, joint_preset=JointPreset.LEGS_ONLY)
    fly.add_joints(skeleton, neutral_pose=KinematicPosePreset.NEUTRAL)
    # 2. Position servos on the biologically active DoFs (42), leg adhesion.
    actuated = fly.skeleton.get_actuated_dofs_from_preset(ActuatedDOFPreset.LEGS_ACTIVE_ONLY)
    fly.add_actuators(actuated, ActuatorType.POSITION, kp=50.0,
                      neutral_input=KinematicPosePreset.NEUTRAL)
    fly.add_leg_adhesion()
    fly.add_joint_sites(fly.skeleton.anatomical_joints)
    fly.colorize()
    fly.add_tracking_camera()
    # 3. On a world.
    world = FlatGroundWorld()
    world.add_fly(fly, (0, 0, 2.0), Rotation3D("quat", (1, 0, 0, 0)))
    return fly, world


def main(device="cuda", out=None, warmup_s: float = 0.05) -> dict:
    """Build, compile, export and settle example 01's fly.

    Args:
        device: "cuda" (the default, K2) or "cpu" (the engine step).
        out: the MJCF's path; None writes ``outputs/01_fly_world.xml``.
        warmup_s: the settle's simulated seconds (the example's 0.05).

    Returns:
        dict with ``nbody``, ``nv``, ``nu``, ``mass`` (the bodies' summed
        mass, as printed), ``first_dofs``, ``path`` (the MJCF), ``found``
        (the legs' contact flags after the settle, on the host) and ``sim``.
    """
    fly, world = build_fly_world()
    model, _state = world.compile()
    mass = float(model.body_mass.sum()) * 1e3
    print(f"bodies: {model.nbody}, DoFs: {model.nv}, actuators: {model.nu}")
    print(f"total mass: {mass:.3f} mg-eq")
    # 4. The canonical orders define the I/O contract.
    first_dofs = [d.name for d in fly.get_jointdofs_order()[:3]]
    print("first joint DoFs:", first_dofs)
    # 5. The MJCF, loadable by any MuJoCo viewer.
    path = Path("outputs/01_fly_world.xml" if out is None else out)
    path.parent.mkdir(parents=True, exist_ok=True)
    world.save_xml_with_assets(path)
    print(f"exported {path}")
    # 6. Settle and read the contacts.
    sim = Simulation(world, device=device)
    sim.set_leg_adhesion_states("fly0", np.ones(6))
    sim.warmup(warmup_s)
    found, _forces, *_ = sim.get_ground_contact_info("fly0")
    found = found.cpu().numpy()
    print("legs in ground contact after settling:", found)
    return dict(nbody=model.nbody, nv=model.nv, nu=model.nu, mass=mass, first_dofs=first_dofs,
                path=path, found=found, sim=sim)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    main(device=args.device, out=args.out)
