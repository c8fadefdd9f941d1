"""Example 11: two flies physically interacting.

``main`` is ``examples/11_two_flies_interacting.py`` in torch: two LEGS_ONLY
flies share one world, "top" dropped from 2 mm above "bottom", and collide
through 49 explicit capsule-capsule contact pair rows between their thorax,
abdomen and head capsules (``World.add_fly_fly_contacts``). The bottom fly
holds on with its leg adhesion; after 800 steps the top fly rests on the
bottom one's back. On the card every step is the mega-step kernel K2
(``rollout`` fuses 8 steps per launch), for one world (``Simulation``) or
a batch (``BatchSimulation``); on the CPU the engine step.

Two options choose among the worlds the JAX package composes from the same
flies, and add no feature: ``condim`` puts the ground contacts and the pair
rows at ``ContactParams(condim=condim)`` (1, 3, 4 or 6), and ``terrain``
drops the flies (at z 1.5 and 3.5) on ``BlocksTerrainWorld()`` with the
pair rows compressed to one row per group of the bottom fly's capsules
(``pair_compress``), each solved against its nearest member.
``flygym_tpu_torch/assets/twofly_condim6.npz`` and ``twofly_terrain.npz``
are these worlds as the JAX package compiles them
(``scripts/export_pair_variants_golden.py``).

The frame from ``bottom/trackcam`` is written as a PNG by :func:`write_png`
(zlib and struct: the card's machine may lack PIL).

Run (``--worlds N`` for a batch; ``--device cpu`` on a machine without a
card)::

    python -m flygym_tpu_torch.demo.two_flies [--worlds N] [--condim {1,3,4,6}] [--terrain]
"""

import argparse
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from flygym_tpu_torch.anatomy import AxisOrder, ContactBodiesPreset, JointPreset, Skeleton
from flygym_tpu_torch.batch import BatchSimulation
from flygym_tpu_torch.compose.fly import Fly
from flygym_tpu_torch.compose.physics import ContactParams
from flygym_tpu_torch.compose.pose import KinematicPosePreset
from flygym_tpu_torch.compose.world import BlocksTerrainWorld, FlatGroundWorld
from flygym_tpu_torch.simulation import Simulation
from flygym_tpu_torch.utils.math import Rotation3D

__all__ = ["REST_GAP_MM", "make_two_fly_world", "main", "write_png"]

REST_GAP_MM = 0.4  # the example's check: the top root this far above the bottom's
N_STEPS = 800  # the example's drop and settle
CAMERA = "bottom/trackcam"
CAMERA_RES = (240, 320)


def make_two_fly_world(condim: int = 3, terrain: bool = False):
    """Example 11's world: "bottom" at (0, 0, 1.2) and "top" at (0, 0, 3.2)
    on flat ground, joined by the pair rows of their thorax, abdomen and
    head capsules; ``condim`` sets the ground contacts' and the pair rows'
    ``ContactParams``; ``terrain`` puts the flies at z 1.5 and 3.5 on
    ``BlocksTerrainWorld()`` with compressed pair rows."""

    def mkfly(name):
        fly = Fly(name=name)
        fly.add_joints(Skeleton(axis_order=AxisOrder.YPR, joint_preset=JointPreset.LEGS_ONLY),
                       neutral_pose=KinematicPosePreset.NEUTRAL)
        fly.add_leg_adhesion()
        fly.colorize()
        fly.add_tracking_camera()
        return fly

    params = ContactParams(condim=condim)
    world = BlocksTerrainWorld() if terrain else FlatGroundWorld()
    z0 = 1.5 if terrain else 1.2
    quat = Rotation3D("quat", (1, 0, 0, 0))
    world.add_fly(mkfly("bottom"), (0, 0, z0), quat, ground_contact_params=params)
    world.add_fly(mkfly("top"), (0, 0, z0 + 2.0), quat, ground_contact_params=params)
    # The trunk-only pair set: enough to carry one fly on the other.
    segs = [s for s in ContactBodiesPreset.LEGS_THORAX_ABDOMEN_HEAD.to_body_segments_list()
            if "thorax" in s.name or "abdomen" in s.name or "head" in s.name]
    world.add_fly_fly_contacts("bottom", "top", bodysegs=segs, contact_params=params)
    if terrain:
        world.spec.options["pair_compress"] = True
    return world


def write_png(path, frame) -> Path:
    """Write an (H, W, 3) uint8 frame as an 8-bit RGB PNG."""
    frame = np.ascontiguousarray(np.asarray(frame, dtype=np.uint8))
    h, w, c = frame.shape
    if c != 3:
        raise ValueError(f"write_png takes (H, W, 3) frames, got {frame.shape}")

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    rows = b"".join(b"\x00" + frame[y].tobytes() for y in range(h))  # filter 0 per row
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows, 6)) + chunk(b"IEND", b""))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(png)
    return path


def main(n_worlds: int = 0, device="cuda", condim: int = 3, terrain: bool = False,
         n_steps: int = N_STEPS, out=None) -> dict:
    """Drop the top fly onto the bottom one and render a frame.

    Args:
        n_worlds: 0 runs one world (``Simulation``), N a batch
            (``BatchSimulation``) of N.
        device: "cuda" (the default, K2) or "cpu" (the engine step).
        condim, terrain: the world (:func:`make_two_fly_world`).
        n_steps: steps of the drop (the example's 800).
        out: the PNG's path; None writes ``outputs/11_two_flies.png``.

    Returns:
        dict with ``z_bottom`` and ``z_top`` (world 0's root heights, mm),
        ``frame`` (the (H, W, 3) uint8 frame on the host), ``path`` and
        ``sim``.

    Raises:
        AssertionError: the top fly does not rest on the bottom one after
            the example's 800 steps (the example's check). It is not made at
            condim 1: without friction the top fly slides off the bottom
            one's back (root z 0.79 mm, both flies on the ground).
    """
    world = make_two_fly_world(condim=condim, terrain=terrain)
    if n_worlds:
        sim = BatchSimulation(world, n_worlds, device=device)
        adhesion = torch.ones((n_worlds, 6), dtype=torch.float32, device=sim.device)
    else:
        sim = Simulation(world, device=device)
        adhesion = torch.ones(6, dtype=torch.float32, device=sim.device)
    print(f"{sim.compiled.model.ncand_pair} capsule-capsule contact pair rows between the "
          f"two flies; the step: {'K2' if sim.megastep else 'the engine step'}")
    sim.set_leg_adhesion_states("bottom", adhesion)

    sim.rollout(None, n_steps, record_trajectory=False)  # drop + settle
    qpos = sim.state.qpos[0].cpu()
    z_bottom = float(qpos[sim.model.free_joints[0][1] + 2])
    z_top = float(qpos[sim.model.free_joints[1][1] + 2])
    print(f"bottom fly root z = {z_bottom:.2f} mm, top fly root z = {z_top:.2f} mm")
    if n_steps >= N_STEPS and condim != 1:
        assert z_top > z_bottom + REST_GAP_MM, "top fly should rest ON the bottom fly"

    renderer = sim.set_renderer(CAMERA, camera_res=CAMERA_RES)
    renderer.render(sim.state)
    frame = renderer.get_frames()[-1]
    if frame.dim() == 4:
        frame = frame[0]
    frame = frame.cpu().numpy()
    path = write_png(Path("outputs/11_two_flies.png") if out is None else out, frame)
    print(f"frame -> {path}")
    return dict(z_bottom=z_bottom, z_top=z_top, frame=frame, path=path, sim=sim)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--worlds", type=int, default=0, help="0: one world; N: a batch of N")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--condim", type=int, choices=(1, 3, 4, 6), default=3)
    parser.add_argument("--terrain", action="store_true",
                        help="BlocksTerrainWorld with compressed pair rows")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    main(args.worlds, device=args.device, condim=args.condim, terrain=args.terrain, out=args.out)
