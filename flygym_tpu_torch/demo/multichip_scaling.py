"""Example 12: worlds split over a mesh of devices.

``main`` is ``examples/12_multichip_scaling.py`` in torch. The one axis of
parallelism is the independent worlds: a 1-D mesh
(:func:`~flygym_tpu_torch.parallel.make_world_mesh`) splits them into one
block per device, and each step runs on every block with no operation
across blocks (on the card, the mega-step kernel K2 once per shard).

Without ``--real`` the mesh is ``n_devices`` shards on one device, the card
(or the CPU with ``--device cpu``), as the JAX example runs its sharded
program on virtual CPU devices; with ``--real`` it is the first
``n_devices`` visible cards. Each shard holds 4 worlds.

Run::

    python -m flygym_tpu_torch.demo.multichip_scaling [n_devices=8] [--real] [--device cpu]
"""

import argparse

import numpy as np
import torch

from flygym_tpu_torch.anatomy import ActuatedDOFPreset, JointPreset, Skeleton
from flygym_tpu_torch.batch import BatchSimulation
from flygym_tpu_torch.compose.fly import ActuatorType, Fly
from flygym_tpu_torch.compose.pose import KinematicPosePreset
from flygym_tpu_torch.compose.world import FlatGroundWorld
from flygym_tpu_torch.parallel import make_world_mesh
from flygym_tpu_torch.utils.math import Rotation3D

__all__ = ["WORLDS_PER_SHARD", "main", "make_world"]

WORLDS_PER_SHARD = 4


def make_world():
    """Example 12's world: the fly "fly" (LEGS_ONLY, position servos on the
    active leg DoFs, leg adhesion) at (0, 0, 2) on flat ground."""
    fly = Fly(name="fly")
    fly.add_joints(Skeleton(axis_order="ypr", joint_preset=JointPreset.LEGS_ONLY),
                   neutral_pose=KinematicPosePreset.NEUTRAL)
    fly.add_actuators(fly.skeleton.get_actuated_dofs_from_preset(ActuatedDOFPreset.LEGS_ACTIVE_ONLY),
                      ActuatorType.POSITION, kp=50.0, neutral_input=KinematicPosePreset.NEUTRAL)
    fly.add_leg_adhesion()
    world = FlatGroundWorld()
    world.add_fly(fly, (0, 0, 2.0), Rotation3D("quat", (1, 0, 0, 0)))
    return world


def main(n_devices: int = 8, real: bool = False, device="cuda", n_steps: int = 50,
         megastep: bool | None = None) -> dict:
    """Step ``4 * n_devices`` worlds split over ``n_devices`` shards: one
    ``step`` and one ``rollout(None, n_steps)`` (the example's 50).

    Args:
        real: the first ``n_devices`` visible cards; else ``n_devices``
            shards on ``device``.
        megastep: the step, as for :class:`BatchSimulation` (None: K2 on the
            card, the engine step on the CPU).

    Returns:
        dict with ``angles`` (the (n_worlds, 66) joint angles), ``traj`` (the
        (n_steps, n_worlds, nq) qpos trajectory) and ``sim``.
    """
    if real:
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"--real needs {n_devices} cards, {torch.cuda.device_count()} "
                               f"are visible")
        devices = list(range(n_devices))
    else:
        devices = [device] * n_devices
    mesh = make_world_mesh(devices)
    print(f"devices: {mesh.size} x {mesh.devices[0].type}")

    n_worlds = WORLDS_PER_SHARD * mesh.size
    sim = BatchSimulation(make_world(), n_worlds, mesh=mesh, megastep=megastep)
    sim.set_leg_adhesion_states("fly", np.ones((n_worlds, 6), np.float32))

    # The state is kept as one block of worlds per shard.
    print("qpos sharding:", [f"{tuple(s.qpos.shape)} on {s.qpos.device}" for s in sim.shards])
    sim.step()
    traj = sim.rollout(None, n_steps)
    angles = sim.get_joint_angles("fly")
    print(f"stepped {n_worlds} worlds over {mesh.size} devices; joint angles "
          f"{tuple(angles.shape)}, trajectory leaf {tuple(traj.shape)}")
    assert bool(torch.isfinite(angles).all())
    print("OK")
    return dict(angles=angles, traj=traj, sim=sim)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", type=int, nargs="?", default=8)
    parser.add_argument("--real", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.n_devices, real=args.real, device=args.device)
