"""Example 02: replaying recorded walking.

``main`` is ``examples/02_replay_recorded_walking.py`` in torch: the
benchmark fly at (0, 0, 1.2) in a batch of one world, settled with adhesion
on, then driven by the Spotlight clip's joint angles (smoothed and
resampled onto the simulation's time grid) through ``rollout``; it prints
where the fly went and renders the final pose at mesh fidelity (the
capsule hits refined against the segments' mesh SDFs). On the card the
replay is K = 8 launches of the mega-step kernel K2 where 8 divides its
length; on the CPU it is the engine step.

Run (``--device cpu`` on a machine without a card)::

    python -m flygym_tpu_torch.demo.replay_recorded_walking [--steps N] [--device cpu]
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from flygym_tpu_torch.batch import BatchSimulation
from flygym_tpu_torch.compose.fly import ActuatorType
from flygym_tpu_torch.demo.benchmark import make_model
from flygym_tpu_torch.demo.spotlight import MotionSnippet

__all__ = ["main"]


def main(n_steps: int = 5000, settle_steps: int = 500, render: bool = True, device="cuda",
         out=None) -> dict:
    """Settle the fly, replay the clip and render its final pose.

    Args:
        n_steps: replay steps, at most the clip's length (the example's 5000).
        settle_steps: the settle (the example's 500).
        render: render the final pose at mesh fidelity and write it.
        device: "cuda" (the default, K2) or "cpu" (the engine step).
        out: the video's path; None writes ``outputs/02_replay_final_frame.mp4``
            (a GIF beside it where no ffmpeg is found).

    Returns:
        dict with ``n_steps`` (the replay's), ``start`` and ``end`` (the
        root's xyz before and after the replay, mm, on the host), ``traj``
        (the one world's (n_steps, nq) qpos trajectory), ``frame`` (the rendered
        (H, W, 3) uint8 frame on the host, or None) and ``sim``.
    """
    fly, world, cam = make_model(spawn_position=(0, 0, 1.2))
    sim = BatchSimulation(world, 1, device=device)

    # Recorded joint angles, smoothed and resampled onto the sim time grid.
    dof_order = fly.get_actuated_jointdofs_order(ActuatorType.POSITION)
    angles = MotionSnippet().get_joint_angles(sim.timestep, dof_order)
    n_steps = min(len(angles), n_steps)
    print(f"replaying {n_steps} steps ({n_steps * sim.timestep:.2f} s)")

    sim.set_leg_adhesion_states(fly.name, np.ones((1, 6), np.float32))
    sim.rollout(None, settle_steps, record_trajectory=False)  # settle on the ground

    act_ids = sim.actuator_ids(fly.name, ActuatorType.POSITION).cpu()
    ctrl_seq = torch.full((n_steps, 1, sim.model.nu), float("nan"))
    ctrl_seq[:, 0, act_ids] = torch.as_tensor(angles[:n_steps], dtype=torch.float32)

    start = sim.state.qpos[0, :3].cpu().numpy()
    traj = sim.rollout(ctrl_seq, n_steps)[:, 0]  # the one world's
    end = sim.state.qpos[0, :3].cpu().numpy()
    print(f"fly moved from {np.round(start, 2)} to {np.round(end, 2)} mm")

    frame = None
    if render:
        renderer = sim.set_renderer(cam, camera_res=(240, 320), world_ids=[0],
                                    mesh_fidelity=True)
        renderer.render(sim.state)
        frame = renderer.get_frames()[-1][0].cpu().numpy()
        path = Path("outputs/02_replay_final_frame.mp4" if out is None else out)
        renderer.save_video(path)
        print(f"wrote {path} (or a .gif beside it)")
    return dict(n_steps=n_steps, start=start, end=end, traj=traj, frame=frame, sim=sim)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=5000)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--no-render", action="store_true")
    args = parser.parse_args()
    main(args.steps, render=not args.no_render, device=args.device)
