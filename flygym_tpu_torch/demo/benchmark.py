"""The headline benchmark: batched kinematic replay of recorded fly walking.

Port of ``flygym_tpu/demo/benchmark.py`` and of ``bench.py``. The protocol
is the reference's: position-actuator replay of the Spotlight clip with leg
adhesion on flat ground, dt = 1e-4 s; the worlds settle for 500 steps, one
untimed replay runs, then a timed replay from its end state. The metric is
``world-steps/s = n_steps * n_worlds / walltime``; :func:`run_benchmark`
sweeps the world count, and :func:`main` prints ``bench.py``'s JSON line::

    python -m flygym_tpu_torch.demo.benchmark [world counts ...]

Where the JAX package scans the episode on the device, the port runs a
Python loop of launches of the simulation's step (the mega-step kernel, K
steps fused per launch, on the card; the eager engine step otherwise); the
timer brackets the replay with ``torch.cuda.synchronize()`` on a CUDA
device.
"""

import json
import sys
from dataclasses import replace
from time import perf_counter

import numpy as np
import torch

from flygym_tpu_torch.batch import BatchSimulation
from flygym_tpu_torch.compose.bridge import CompiledModel, load_compiled
from flygym_tpu_torch.demo.spotlight import MotionSnippet
from flygym_tpu_torch.engine.step import step

__all__ = [
    "GOLDEN_TOLERANCE",
    "ReplayTargetData",
    "main",
    "make_model",
    "replay_episode",
    "run_benchmark",
    "run_simulation",
    "track_controls",
    "track_golden",
]

# bench.py's protocol and baseline: 1000 replay steps at dt = 1e-4 s, against
# the reference's best published GPU number (BASELINE.md).
SIM_STEPS = 1000
TIMESTEP = 1e-4
BASELINE_STEPS_PER_S = 600_000.0
DEFAULT_WORLDS = 8192

# How far the port may stray from the JAX golden over its 50 replay steps.
# The steps start with a jump of the targets: the position actuators drive
# |qvel| to ~65 rad/s and contacts switch on and off. fp32 sums taken in
# another order (other matmul kernels, another CPU thread count, atomics on
# the card) then differ by up to 5e-2 in qvel at the steps where contact
# rows switch, and by 1e-5 in qpos (measured on the CPU and on the H100). A
# contact's found flag can flip only where its distance is within such a
# difference of its margin.
GOLDEN_TOLERANCE = {"qpos": 1e-4, "qvel": 0.25, "found_share": 0.01}


# make_model's arguments as the JAX package's defaults give them (enums by
# their values, the rotation as its quaternion).
_MODEL_DEFAULTS = {
    "joints_preset": "legs_only",
    "actuated_dofs_preset": "legs_active_only",
    "actuator_type": "position",
    "position_gain": 50.0,
    "neutral_pose": "neutral",
    "spawn_position": (0, 0, 0.8),
    "spawn_rotation": (1, 0, 0, 0),
    "simplify_geom": False,
    "trim_contacts": False,
}


def _plain(value):
    """An argument as comparable data: an enum's value, a rotation's
    quaternion, a sequence as a tuple of floats."""
    value = getattr(value, "values", getattr(value, "value", value))
    if isinstance(value, (list, tuple, np.ndarray)):
        return tuple(float(x) for x in value)
    return value


def make_model(joints_preset="legs_only", actuated_dofs_preset="legs_active_only",
               actuator_type="position", position_gain=50.0, neutral_pose="neutral",
               spawn_position=(0, 0, 0.8), spawn_rotation=(1, 0, 0, 0), simplify_geom=False,
               trim_contacts=False) -> CompiledModel:
    """The benchmark fly and world (``flygym_tpu/demo/benchmark.py:45-112``)
    as the port has it: the exported compile of the JAX defaults,
    :func:`~flygym_tpu_torch.compose.bridge.load_compiled`'s default. The
    presets, actuator type and pose take the JAX enums or their values, the
    rotation a ``Rotation3D`` or its quaternion.

    The port compiles no world itself, so an argument other than its JAX
    default raises ``NotImplementedError``.
    """
    given = dict(joints_preset=joints_preset, actuated_dofs_preset=actuated_dofs_preset,
                 actuator_type=actuator_type, position_gain=position_gain,
                 neutral_pose=neutral_pose, spawn_position=spawn_position,
                 spawn_rotation=spawn_rotation, simplify_geom=simplify_geom,
                 trim_contacts=trim_contacts)
    other = sorted(k for k, v in given.items() if _plain(v) != _plain(_MODEL_DEFAULTS[k]))
    if other:
        raise NotImplementedError(
            f"make_model: {', '.join(other)} other than the JAX default needs a compile of "
            "the world, which the port does not have yet (ROADMAP.md queue 1 item 9, the "
            "JAX-free compile)")
    return load_compiled()


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


def replay_episode(sim: BatchSimulation, state, targets: torch.Tensor, act_ids: torch.Tensor,
                   n_steps: int, on_step=None):
    """Replay ``targets`` (B, n_steps, n_dofs) into the actuators ``act_ids``
    through ``sim``'s step (:meth:`~flygym_tpu_torch.Simulation.step_fns`).

    With the K-step mega-step each launch takes the chunk's K target slices
    written into its (K, B, nu) controls (``flygym_tpu/demo/benchmark.py:
    144-170``); otherwise one step per target row. ``on_step(i, state)``, if
    given, sees the state after each launch, ``i`` the index of its last
    step."""
    batched_step, kstep_fn = sim.step_fns(n_steps)
    if kstep_fn is not None:
        K = kstep_fn.k_steps
        for i in range(0, n_steps, K):
            ctrl_seq = state.ctrl.expand((K,) + state.ctrl.shape).clone()
            ctrl_seq[:, :, act_ids] = targets[:, i : i + K].transpose(0, 1)
            state, _traj = kstep_fn(state, ctrl_seq)
            if on_step is not None:
                on_step(i + K - 1, state)
        return state
    if batched_step is None:
        batched_step = lambda s: step(sim.model, s)
    for i in range(n_steps):
        ctrl = state.ctrl.clone()
        ctrl[:, act_ids] = targets[:, i]
        state = batched_step(replace(state, ctrl=ctrl))
        if on_step is not None:
            on_step(i, state)
    return state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_simulation(compiled: CompiledModel, replay_data: np.ndarray, *,
                   device="cuda", warmup_steps: int = 500, megastep: bool | None = None,
                   megastep_k: int = 8):
    """Settle, replay once untimed, then time a replay from the first one's
    end state (``flygym_tpu/demo/benchmark.py:189-240``; reference
    ``time_gpu_simulation.py:108-156``). The untimed replay keeps the
    kernels' builds and first launches outside the timer.

    Args:
        replay_data: (n_worlds, n_steps, n_dofs) target angles.
        megastep, megastep_k: The step, as for :class:`BatchSimulation`.

    Returns:
        (walltime of the timed replay in seconds, the simulation after it).
    """
    n_worlds, n_steps, _ = replay_data.shape
    sim = BatchSimulation(compiled, n_worlds, device=device, megastep=megastep,
                          megastep_k=megastep_k)
    fly = compiled.fly_names[0]
    sim.set_leg_adhesion_states(fly, np.ones((n_worlds, 6), np.float32))
    sim.rollout(None, warmup_steps, record_trajectory=False)

    act_ids = sim.actuator_ids(fly, "position")
    targets = torch.as_tensor(replay_data, dtype=torch.float32, device=sim.device)
    sim.state = replay_episode(sim, sim.state, targets, act_ids, n_steps)
    _sync(sim.device)
    start = perf_counter()
    sim.state = replay_episode(sim, sim.state, targets, act_ids, n_steps)
    _sync(sim.device)
    return perf_counter() - start, sim


def _position_dofs(compiled: CompiledModel) -> list:
    fly = compiled.fly_names[0]
    return [tuple(d) for d in compiled.flies[fly]["actuated_dofs"]["position"]]


def run_benchmark(min_worlds: int, max_worlds: int, factor: int, sim_timestep: float = TIMESTEP,
                  sim_steps: int = SIM_STEPS, *, device="cuda", warmup_steps: int = 500,
                  enable_rendering: bool = False, simplify_geom: bool = False) -> dict:
    """The world-count sweep (``flygym_tpu/demo/benchmark.py:243-283``;
    reference ``time_gpu_simulation.py:159-198``): :func:`run_simulation` at
    ``min_worlds``, then times ``factor`` while at most ``max_worlds``,
    printing each count's walltime and world-steps/s. The card running out
    of memory ends the sweep; any other error propagates.

    Returns:
        numpy columns ``n_worlds``, ``walltime_s``, ``steps_per_second``
        (``sim_steps * n_worlds / walltime``) and ``realtime_factor``
        (``steps_per_second * sim_timestep``), one entry per count run.
    """
    if enable_rendering:
        raise NotImplementedError("rendering waits for the port's renderer (ROADMAP.md queue 1 "
                                  "item 5)")
    if factor < 2:
        raise ValueError(f"factor must be >= 2, got {factor}")
    compiled = make_model(simplify_geom=simplify_geom)
    if compiled.model.timestep != sim_timestep:
        raise ValueError(f"the model's timestep is {compiled.model.timestep}, not {sim_timestep}")
    replay = ReplayTargetData(sim_timestep, _position_dofs(compiled))
    counts, walltimes = [], []
    n_worlds = min_worlds
    while True:
        targets = replay.make_target_angles_all_worlds(n_worlds, sim_steps)
        try:
            walltime, _sim = run_simulation(compiled, targets, device=device,
                                            warmup_steps=warmup_steps)
        except torch.cuda.OutOfMemoryError as e:
            print(f"Simulation failed for n_worlds={n_worlds}: {e}", flush=True)
            break
        print(f"Simulated {sim_steps} steps * {n_worlds} worlds in {walltime:.2f}s "
              f"({sim_steps * n_worlds / walltime:,.0f} world-steps/s)", flush=True)
        counts.append(n_worlds)
        walltimes.append(walltime)
        n_worlds *= factor
        if n_worlds > max_worlds:
            break
    n = np.asarray(counts, np.int64)
    walltime = np.asarray(walltimes, np.float64)
    steps_per_second = sim_steps * n / walltime
    return {"n_worlds": n, "walltime_s": walltime, "steps_per_second": steps_per_second,
            "realtime_factor": steps_per_second * sim_timestep}


def main(argv=None) -> int:
    """``bench.py`` on the port, on the card: the replay at each world count
    of ``argv`` (default ``sys.argv[1:]``, or 8192), each count's line on
    stderr, then bench.py's JSON line with the best world-steps/s on stdout,
    last. A count that runs the card out of memory is skipped; returns 1
    when no count ran."""
    args = sys.argv[1:] if argv is None else argv
    world_counts = [int(x) for x in args] or [DEFAULT_WORLDS]
    compiled = make_model()
    replay = ReplayTargetData(TIMESTEP, _position_dofs(compiled))
    best = 0.0
    for n_worlds in world_counts:
        targets = replay.make_target_angles_all_worlds(n_worlds, SIM_STEPS)
        try:
            walltime, _sim = run_simulation(compiled, targets)
        except torch.cuda.OutOfMemoryError as e:
            print(f"n_worlds={n_worlds} failed: {e}", file=sys.stderr)
            continue
        steps_per_s = SIM_STEPS * n_worlds / walltime
        print(f"n_worlds={n_worlds}: {walltime:.2f}s -> {steps_per_s:,.0f} world-steps/s "
              f"({steps_per_s * TIMESTEP:.1f}x realtime)", file=sys.stderr)
        best = max(best, steps_per_s)
    if best == 0.0:
        print("no world count ran", file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": "aggregate fly world-steps/s (kinematic replay, dt=1e-4)",
        "value": round(best),
        "unit": "world-steps/s",
        "vs_baseline": round(best / BASELINE_STEPS_PER_S, 3),
    }), flush=True)
    return 0


def track_golden(compiled: CompiledModel, golden: dict, *, device="cuda", n_worlds=None,
                 megastep: bool | None = None) -> dict:
    """Replay the golden's steps from its settled JAX state on ``device``,
    one step per launch so that every step is compared; ``megastep`` picks
    the path as for :class:`BatchSimulation`.

    Returns the largest |port - JAX| over all steps for ``qpos`` and
    ``qvel``, and ``found_share``, the share of (step, world, sensor) contact
    found flags that differ; compare them with :data:`GOLDEN_TOLERANCE`.
    """
    n_worlds = n_worlds or golden["targets"].shape[0]
    n_steps = golden["targets"].shape[1]
    sim = BatchSimulation(compiled, n_worlds, device=device, megastep=megastep, megastep_k=1)
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
    replay_episode(sim, state, targets, act_ids, n_steps, on_step=on_step)
    return worst


def track_controls(compiled: CompiledModel, golden: dict, record: str, *, device="cuda",
                   n_worlds=None, n_steps=None, megastep: bool | None = None) -> dict:
    """Step the golden's settled state with its per-step controls
    (``golden["ctrl"]``, (n_steps, B, nu), as
    :func:`~flygym_tpu_torch.compose.bridge.load_actuator_golden` gives it)
    one step per launch on ``device``, the path chosen by ``megastep`` as for
    :class:`BatchSimulation`, against the JAX trajectory ``golden[record]``.

    Returns, over the first ``n_steps`` steps (all by default), per step the
    largest |port - JAX| of ``qpos``, ``qvel`` and ``act`` as (n_steps,)
    arrays, and ``found_share``, the share of contact found flags that
    differ.
    """
    rec = golden[record]
    n_worlds = n_worlds or golden["ctrl"].shape[1]
    n_steps = n_steps or golden["ctrl"].shape[0]
    sim = BatchSimulation(compiled, n_worlds, device=device, megastep=megastep, megastep_k=1)
    dev = sim.device
    sim.state = golden["state"].map(lambda x: x[:n_worlds].clone()).to(dev)
    ctrl = torch.as_tensor(golden["ctrl"][:n_steps, :n_worlds], device=dev)
    gaps = {key: np.zeros(n_steps) for key in ("qpos", "qvel", "act")}
    found = 0.0
    for i in range(n_steps):
        sim.rollout(ctrl[i:i + 1], 1, record_trajectory=False)
        for key, gap in gaps.items():
            want = torch.as_tensor(rec[key][i, :n_worlds], device=dev)
            if want.numel():
                gap[i] = (getattr(sim.state, key) - want).abs().max().item()
        want = torch.as_tensor(rec["sensordata"][i, :n_worlds, :, 0], device=dev)
        if want.numel():  # a world without contact sensors has no flags
            found += (sim.state.contact_sensordata[..., 0] != want).float().mean().item() / n_steps
    return {**gaps, "found_share": found}


if __name__ == "__main__":
    sys.exit(main())
