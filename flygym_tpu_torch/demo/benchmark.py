"""The headline benchmark: batched kinematic replay of recorded fly walking.

Port of ``flygym_tpu/demo/benchmark.py:115-240``. The protocol is the
reference's: position-actuator replay of the Spotlight clip with leg
adhesion on flat ground, dt = 1e-4 s; the worlds first settle for 500 steps,
then one timed replay runs. The metric is
``world-steps/s = n_steps * n_worlds / walltime``.

Where the JAX package scans the episode on the device, the port runs a
Python loop of eager batched steps; the timer brackets the replay with
``torch.cuda.synchronize()`` on a CUDA device.
"""

from dataclasses import replace
from time import perf_counter

import numpy as np
import torch

from flygym_tpu_torch.batch import BatchSimulation
from flygym_tpu_torch.compose.bridge import CompiledModel
from flygym_tpu_torch.demo.spotlight import MotionSnippet
from flygym_tpu_torch.engine.step import step

__all__ = [
    "GOLDEN_TOLERANCE",
    "ReplayTargetData",
    "replay_episode",
    "run_simulation",
    "track_golden",
]

# How far the port may stray from the JAX golden over its 50 replay steps.
# The steps start with a jump of the targets: the position actuators drive
# |qvel| to ~65 rad/s and contacts switch on and off. fp32 sums taken in
# another order (other matmul kernels, another CPU thread count, atomics on
# the card) then differ by up to 5e-2 in qvel at the steps where contact
# rows switch, and by 1e-5 in qpos (measured on the CPU and on the H100). A
# contact's found flag can flip only where its distance is within such a
# difference of its margin.
GOLDEN_TOLERANCE = {"qpos": 1e-4, "qvel": 0.25, "found_share": 0.01}


class ReplayTargetData:
    """The Spotlight clip resampled to the simulation's timestep and
    partitioned across worlds (reference ``time_gpu_simulation.py:67-86``).

    Args:
        output_dof_order: (leg, parent link, child link, axis) tuples, e.g.
            ``sim.actuated_dofs(fly, "position")``.
    """

    def __init__(self, sim_timestep: float, output_dof_order: list):
        self.snippet = MotionSnippet()
        self.dof_angles = self.snippet.get_joint_angles(sim_timestep, output_dof_order)
        self.n_total_steps, self.n_dofs = self.dof_angles.shape

    def make_target_angles_all_worlds(self, n_worlds: int, sim_steps: int) -> np.ndarray:
        """(n_worlds, sim_steps, n_dofs): world w replays partition w mod P."""
        out = np.zeros((n_worlds, sim_steps, self.n_dofs), np.float32)
        n_partitions = max(self.n_total_steps // sim_steps, 1)
        for world in range(n_worlds):
            start = (world % n_partitions) * sim_steps
            chunk = self.dof_angles[start : start + sim_steps]
            out[world, : len(chunk)] = chunk
        return out


def replay_episode(model, state, targets: torch.Tensor, act_ids: torch.Tensor,
                   n_steps: int, on_step=None):
    """Replay ``targets`` (B, n_steps, n_dofs) into the actuators ``act_ids``,
    one batched step per target row. ``on_step(i, state)``, if given, sees
    the state after each step."""
    for i in range(n_steps):
        ctrl = state.ctrl.clone()
        ctrl[:, act_ids] = targets[:, i]
        state = step(model, replace(state, ctrl=ctrl))
        if on_step is not None:
            on_step(i, state)
    return state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_simulation(compiled: CompiledModel, replay_data: np.ndarray, *,
                   device="cuda", warmup_steps: int = 500):
    """Settle, then time one replay run (reference ``time_gpu_simulation.py:108-156``).

    Args:
        replay_data: (n_worlds, n_steps, n_dofs) target angles.

    Returns:
        (walltime of the replay in seconds, the simulation after it).
    """
    n_worlds, n_steps, _ = replay_data.shape
    sim = BatchSimulation(compiled, n_worlds, device=device)
    fly = compiled.fly_names[0]
    sim.set_leg_adhesion_states(fly, np.ones((n_worlds, 6), np.float32))
    sim.rollout(None, warmup_steps, record_trajectory=False)

    act_ids = sim.actuator_ids(fly, "position")
    targets = torch.as_tensor(replay_data, dtype=torch.float32, device=sim.device)
    _sync(sim.device)
    start = perf_counter()
    sim.state = replay_episode(sim.model, sim.state, targets, act_ids, n_steps)
    _sync(sim.device)
    return perf_counter() - start, sim


def track_golden(compiled: CompiledModel, golden: dict, *, device="cpu", n_worlds=None) -> dict:
    """Replay the golden's steps from its settled JAX state on ``device``.

    Returns the largest |port - JAX| over all steps for ``qpos`` and
    ``qvel``, and ``found_share``, the share of (step, world, sensor) contact
    found flags that differ; compare them with :data:`GOLDEN_TOLERANCE`.
    """
    n_worlds = n_worlds or golden["targets"].shape[0]
    n_steps = golden["targets"].shape[1]
    sim = BatchSimulation(compiled, n_worlds, device=device)
    dev = sim.device
    state = golden["state"].map(lambda x: x[:n_worlds].clone()).to(dev)
    ref = {k: torch.as_tensor(golden[k][:, :n_worlds], device=dev)
           for k in ("qpos", "qvel", "sensordata")}
    worst = {"qpos": 0.0, "qvel": 0.0, "found_share": 0.0}

    def on_step(i, st):
        worst["qpos"] = max(worst["qpos"], (st.qpos - ref["qpos"][i]).abs().max().item())
        worst["qvel"] = max(worst["qvel"], (st.qvel - ref["qvel"][i]).abs().max().item())
        differ = st.contact_sensordata[..., 0] != ref["sensordata"][i][..., 0]
        worst["found_share"] += differ.float().mean().item() / n_steps

    targets = torch.as_tensor(golden["targets"][:n_worlds], device=dev)
    act_ids = sim.actuator_ids(compiled.fly_names[0], "position")
    replay_episode(sim.model, state, targets, act_ids, n_steps, on_step=on_step)
    return worst
