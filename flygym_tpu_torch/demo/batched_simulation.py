"""Example 03: batched (and multi-card) simulation.

``main`` is ``examples/03_batched_simulation.py`` in torch: the benchmark
fly in ``n_worlds`` worlds of one batch, settled (500 steps) and then
replaying, each world its own partition of the Spotlight clip, through
``rollout``: one untimed replay and one timed replay, whose world-steps/s
it prints; then one frame of 16 worlds from the tracking camera, tiled
into a labelled montage and written as a PNG. On the card the settle is
K = 1 launches of the mega-step kernel K2 (8 does not divide 500) and each
replay K = 8 launches; on the CPU it is the engine step.

With a mesh (:func:`~flygym_tpu_torch.parallel.make_world_mesh`) the worlds
are split over its devices, where the JAX example has a comment::

    mesh = make_world_mesh()   # every visible card
    main(n_worlds, mesh=mesh)

Run (``--device cpu`` on a machine without a card)::

    python -m flygym_tpu_torch.demo.batched_simulation [n_worlds] [--device cpu]
"""

import argparse
import time
from pathlib import Path

import numpy as np

from flygym_tpu_torch.batch import BatchSimulation
from flygym_tpu_torch.compose.fly import ActuatorType
from flygym_tpu_torch.demo.benchmark import ReplayTargetData, make_model
from flygym_tpu_torch.demo.two_flies import write_png
from flygym_tpu_torch.utils.video import montage_grid

__all__ = ["main"]

MONTAGE_WORLDS = 16


def main(n_worlds: int = 512, n_steps: int = 1000, settle_steps: int = 500, device="cuda",
         mesh=None, out=None) -> dict:
    """Settle ``n_worlds`` worlds, replay the clip twice (the second timed)
    and write a montage of the first 16 worlds.

    Args:
        n_steps: the replay's steps (the example's 1000).
        settle_steps: the settle (the example's 500).
        device: "cuda" (the default, K2) or "cpu" (the engine step); with a
            ``mesh``, its first device.
        mesh: a :class:`~flygym_tpu_torch.parallel.WorldMesh` to split the
            worlds over, or None.
        out: the montage's path; None writes ``outputs/03_batch_montage.png``.

    Returns:
        dict with ``wall`` (the timed replay's seconds), ``steps_per_s``,
        ``qpos`` (the final (n_worlds, nq) qpos on the host), ``montage``
        and ``path``, and ``sim``.
    """
    fly, world, _cam = make_model()
    sim = BatchSimulation(world, n_worlds, device=None if mesh is not None else device,
                          mesh=mesh)

    sim.set_leg_adhesion_states(fly.name, np.ones((n_worlds, 6), np.float32))
    sim.rollout(None, settle_steps, record_trajectory=False)  # settle

    # Each world replays a different partition of the recorded walking clip.
    replay = ReplayTargetData(sim.timestep, fly.get_actuated_jointdofs_order(ActuatorType.POSITION))
    targets = replay.make_target_angles_all_worlds(n_worlds, n_steps)
    act_ids = sim.actuator_ids(fly.name, ActuatorType.POSITION).cpu().numpy()
    ctrl_seq = np.full((n_steps, n_worlds, sim.model.nu), np.nan, np.float32)
    ctrl_seq[:, :, act_ids] = np.swapaxes(targets, 0, 1)

    sim.rollout(ctrl_seq, n_steps, record_trajectory=False)  # builds outside the timer
    start = time.perf_counter()
    sim.rollout(ctrl_seq, n_steps, record_trajectory=False)
    sim.synchronize()
    wall = time.perf_counter() - start

    steps_per_s = n_steps * n_worlds / wall
    print(f"{n_worlds} worlds x {n_steps} steps in {wall:.2f} s "
          f"-> {steps_per_s:,.0f} world-steps/s "
          f"({steps_per_s * sim.timestep:.1f}x realtime aggregate)")

    # One frame of 16 worlds in one batched render, tiled into a montage.
    renderer = sim.set_renderer("trackcam", camera_res=(120, 160),
                                world_ids=list(range(min(MONTAGE_WORLDS, n_worlds))))
    renderer.render(sim.state)
    montage = montage_grid(renderer.get_frames()[-1], renderer.world_ids)
    path = write_png(Path("outputs/03_batch_montage.png") if out is None else out, montage)
    print(f"{len(renderer.world_ids)}-world montage -> {path}")
    return dict(wall=wall, steps_per_s=steps_per_s, qpos=sim.state.qpos.cpu().numpy(),
                montage=montage, path=path, sim=sim)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_worlds", type=int, nargs="?", default=512)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.n_worlds, device=args.device)
