"""The headline benchmark: batched kinematic replay of recorded fly walking.

Port of ``flygym_tpu/demo/benchmark.py`` and of ``bench.py``. The protocol
is the reference's: position-actuator replay of the Spotlight clip with leg
adhesion on flat ground, dt = 1e-4 s; the worlds settle for 500 steps, one
untimed replay runs, then a timed replay from its end state. The metric is
``world-steps/s = n_steps * n_worlds / walltime``; :func:`run_benchmark`
sweeps the world count, and :func:`main` prints ``bench.py``'s JSON line.
The benchmark world is composed and compiled by the port
(:func:`make_model`)::

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

from flygym_tpu_torch.anatomy import (
    ALL_SEGMENT_NAMES,
    ActuatedDOFPreset,
    AxisOrder,
    BodySegment,
    JointPreset,
    Skeleton,
)
from flygym_tpu_torch.batch import BatchSimulation
from flygym_tpu_torch.compose.bridge import CompiledModel
from flygym_tpu_torch.compose.fly import ActuatorType, Fly, GeomFittingOption
from flygym_tpu_torch.compose.pose import KinematicPosePreset
from flygym_tpu_torch.compose.world import FlatGroundWorld
from flygym_tpu_torch.demo.spotlight import MotionSnippet
from flygym_tpu_torch.parallel.mesh import gather_world_axis, shard_world_axis
from flygym_tpu_torch.utils.math import Rotation3D
from flygym_tpu_torch.utils.profiling import span

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


def _value(x):
    """An enum argument as its value, so that the port's enums, their values
    and the JAX package's enums all select the same preset."""
    return getattr(x, "value", x)


def make_model(joints_preset=JointPreset.LEGS_ONLY,
               actuated_dofs_preset=ActuatedDOFPreset.LEGS_ACTIVE_ONLY,
               actuator_type=ActuatorType.POSITION, position_gain=50.0,
               neutral_pose=KinematicPosePreset.NEUTRAL, spawn_position=(0, 0, 0.8),
               spawn_rotation=Rotation3D("quat", (1, 0, 0, 0)), simplify_geom=False,
               trim_contacts=False):
    """The canonical benchmark fly and world, composed by the port
    (``flygym_tpu/demo/benchmark.py:45-112``; reference
    ``time_gpu_simulation.py:21-64``): ``(fly, world, cam)``. Compile with
    ``world.compile()`` or hand the world to :class:`BatchSimulation`.

    Args:
        joints_preset, actuated_dofs_preset, actuator_type, neutral_pose:
            The presets, as the port's enums or their values (the JAX
            package's enums are taken by value too).
        spawn_rotation: A ``Rotation3D`` or a (w, x, y, z) quaternion.
        simplify_geom: Capsule-fit inertia for every segment
            (``GeomFittingOption.ALL_TO_CAPSULES``).
        trim_contacts: Single-world latency specialisation: ground contact
            only for the distal tarsal links (tarsus3-5, 36 candidates
            against the default preset's 110) and no ground-contact sensors.
            The JAX package measured its flat-ground walking replay within
            1e-3 mm of the full preset's COM over 2,000 steps (only tarsal
            rows activate there); keep False on rugged terrain or in
            collisions, where other segments touch.
    """
    geom_fitting = (
        GeomFittingOption.ALL_TO_CAPSULES if simplify_geom else GeomFittingOption.UNMODIFIED
    )
    fly = Fly(geom_fitting_option=geom_fitting)
    skeleton = Skeleton(axis_order=AxisOrder.YAW_PITCH_ROLL,
                        joint_preset=JointPreset(_value(joints_preset)))
    if neutral_pose is not None and not hasattr(neutral_pose, "joint_angles_lookup_rad"):
        neutral_pose = KinematicPosePreset(_value(neutral_pose))
    fly.add_joints(skeleton, neutral_pose=neutral_pose)
    actuated = fly.skeleton.get_actuated_dofs_from_preset(
        ActuatedDOFPreset(_value(actuated_dofs_preset)))
    fly.add_actuators(actuated, actuator_type=ActuatorType(_value(actuator_type)),
                      kp=position_gain, neutral_input=neutral_pose)
    fly.add_leg_adhesion()
    fly.colorize()
    cam = fly.add_tracking_camera()

    if hasattr(spawn_rotation, "format"):
        spawn_rotation = Rotation3D(spawn_rotation.format, tuple(spawn_rotation.values))
    else:
        spawn_rotation = Rotation3D("quat", tuple(spawn_rotation))
    world = FlatGroundWorld()
    if trim_contacts:
        tips = [BodySegment(n) for n in ALL_SEGMENT_NAMES
                if n.split("_", 1)[-1] in ("tarsus3", "tarsus4", "tarsus5")]
        world.add_fly(fly, spawn_position, spawn_rotation, bodysegs_with_ground_contact=tips,
                      add_ground_contact_sensors=False)
    else:
        world.add_fly(fly, spawn_position, spawn_rotation)
    return fly, world, cam


class ReplayTargetData:
    """The Spotlight clip resampled to the simulation's timestep and
    partitioned across worlds (reference ``time_gpu_simulation.py:67-86``).

    Args:
        output_dof_order: Joint DoFs, e.g.
            ``fly.get_actuated_jointdofs_order("position")``, or (leg, parent
            link, child link, axis) tuples, e.g.
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


def replay_episode(sim: BatchSimulation, states: list, targets: torch.Tensor,
                   act_ids: torch.Tensor, n_steps: int, on_step=None) -> list:
    """Replay ``targets`` (B, n_steps, n_dofs) into the actuators ``act_ids``
    through ``sim``'s step (:meth:`~flygym_tpu_torch.Simulation.step_fns`)
    from ``states``, a list of per-shard States as ``sim.shards`` holds
    them; returns the shards after the replay.

    With the K-step mega-step each launch takes the chunk's K target slices
    written into its (K, b, nu) controls (``flygym_tpu/demo/benchmark.py:
    144-170``); otherwise one step per target row. Every shard is launched
    before the next chunk. ``on_step(i, state)``, if given, sees the state
    after each launch (the shards joined), ``i`` the index of its last
    step. Each chunk (K steps, or one step without the mega-step) is the
    span ``flygym.replay.chunk``, its id the chunk's index."""
    batched_step, kstep_fn = sim.step_fns(n_steps)
    shards = shard_world_axis(targets, sim.mesh)
    ids = [act_ids.to(t.device) for t in shards]
    if kstep_fn is not None:
        K = kstep_fn.k_steps
        for i in range(0, n_steps, K):
            with span("flygym.replay.chunk", i // K):
                seqs = []
                for s, t, a in zip(states, shards, ids):
                    seq = s.ctrl.expand((K,) + s.ctrl.shape).clone()
                    seq[:, :, a] = t[:, i : i + K].transpose(0, 1)
                    seqs.append(seq)
                states, _rows = kstep_fn(states, seqs)
            if on_step is not None:
                on_step(i + K - 1, gather_world_axis(states))
        return states
    for i in range(n_steps):
        with span("flygym.replay.chunk", i):
            stepped = []
            for s, t, a in zip(states, shards, ids):
                ctrl = s.ctrl.clone()
                ctrl[:, a] = t[:, i]
                stepped.append(replace(s, ctrl=ctrl))
            states = batched_step(stepped)
        if on_step is not None:
            on_step(i, gather_world_axis(states))
    return states


def run_simulation(compiled, replay_data: np.ndarray, *,
                   device="cuda", warmup_steps: int = 500, megastep: bool | None = None,
                   megastep_k: int = 8, enable_rendering: bool = False, mesh=None):
    """Settle, replay once untimed, then time a replay from the first one's
    end state (``flygym_tpu/demo/benchmark.py:189-240``; reference
    ``time_gpu_simulation.py:108-156``). The untimed replay keeps the
    kernels' builds and first launches outside the timer.

    Args:
        compiled: A :class:`CompiledModel`, or a composed world, which the
            simulation compiles.
        replay_data: (n_worlds, n_steps, n_dofs) target angles.
        megastep, megastep_k, mesh: The step, and the mesh to split the
            worlds over, as for :class:`BatchSimulation`.
        enable_rendering: Attach the tracking camera ``trackcam``
            (``playback_speed=0.2, output_fps=25``) and render one frame of
            world 0 after the timed replay, outside the timer, as the JAX
            package does.

    Returns:
        (walltime of the timed replay in seconds, the simulation after it).
    """
    n_worlds, n_steps, _ = replay_data.shape
    sim = BatchSimulation(compiled, n_worlds, device=device, megastep=megastep,
                          megastep_k=megastep_k, mesh=mesh)
    if enable_rendering:
        sim.set_renderer("trackcam", playback_speed=0.2, output_fps=25)
    fly = sim.compiled.fly_names[0]
    sim.set_leg_adhesion_states(fly, np.ones((n_worlds, 6), np.float32))
    sim.rollout(None, warmup_steps, record_trajectory=False)

    act_ids = sim.actuator_ids(fly, "position")
    targets = torch.as_tensor(replay_data, dtype=torch.float32, device=sim.device)
    sim.shards = replay_episode(sim, sim.shards, targets, act_ids, n_steps)
    sim.synchronize()
    start = perf_counter()
    sim.shards = replay_episode(sim, sim.shards, targets, act_ids, n_steps)
    sim.synchronize()
    walltime = perf_counter() - start
    if enable_rendering:
        sim.render_as_needed()
    return walltime, sim


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
    of memory ends the sweep; any other error propagates. With
    ``enable_rendering`` each run renders one frame after its timed replay
    (:func:`run_simulation`).

    Returns:
        numpy columns ``n_worlds``, ``walltime_s``, ``steps_per_second``
        (``sim_steps * n_worlds / walltime``) and ``realtime_factor``
        (``steps_per_second * sim_timestep``), one entry per count run, and
        with ``enable_rendering`` the ``frames``: each run's rendered frames
        (one (1, 240, 320, 3) uint8 tensor of world 0).
    """
    if factor < 2:
        raise ValueError(f"factor must be >= 2, got {factor}")
    _fly, world, _cam = make_model(simplify_geom=simplify_geom)
    world.compile()
    compiled = world.compiled
    if compiled.model.timestep != sim_timestep:
        raise ValueError(f"the model's timestep is {compiled.model.timestep}, not {sim_timestep}")
    replay = ReplayTargetData(sim_timestep, _position_dofs(compiled))
    counts, walltimes, frames = [], [], []
    n_worlds = min_worlds
    while True:
        targets = replay.make_target_angles_all_worlds(n_worlds, sim_steps)
        try:
            walltime, sim = run_simulation(compiled, targets, device=device,
                                           warmup_steps=warmup_steps,
                                           enable_rendering=enable_rendering)
        except torch.cuda.OutOfMemoryError as e:
            print(f"Simulation failed for n_worlds={n_worlds}: {e}", flush=True)
            break
        print(f"Simulated {sim_steps} steps * {n_worlds} worlds in {walltime:.2f}s "
              f"({sim_steps * n_worlds / walltime:,.0f} world-steps/s)", flush=True)
        counts.append(n_worlds)
        walltimes.append(walltime)
        if enable_rendering:
            frames.append(sim.renderer.get_frames())
        n_worlds *= factor
        if n_worlds > max_worlds:
            break
    n = np.asarray(counts, np.int64)
    walltime = np.asarray(walltimes, np.float64)
    steps_per_second = sim_steps * n / walltime
    out = {"n_worlds": n, "walltime_s": walltime, "steps_per_second": steps_per_second,
           "realtime_factor": steps_per_second * sim_timestep}
    if enable_rendering:
        out["frames"] = frames
    return out


def main(argv=None) -> int:
    """``bench.py`` on the port, on the card: the replay at each world count
    of ``argv`` (default ``sys.argv[1:]``, or 8192), each count's line on
    stderr, then bench.py's JSON line with the best world-steps/s on stdout,
    last. A count that runs the card out of memory is skipped; returns 1
    when no count ran."""
    args = sys.argv[1:] if argv is None else argv
    world_counts = [int(x) for x in args] or [DEFAULT_WORLDS]
    _fly, world, _cam = make_model()
    world.compile()
    compiled = world.compiled
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
    sim.state = state
    replay_episode(sim, sim.shards, targets, act_ids, n_steps, on_step=on_step)
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
