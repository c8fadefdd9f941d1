"""Single-world simulation runtime.

Port of ``flygym_tpu/simulation.py``: construct from a composed world
(which it compiles, as the JAX package does) or from a compiled model,
``step()`` / ``step_with_profile()`` / ``warmup()`` / ``reset()``, roll out,
read state in the fly's canonical orders, write control inputs, attach a
renderer and render as simulated time passes, save and load the state, and
print the performance report from the runtime's counters. The state is a batch of one world (B = 1); getters return that
world. :class:`flygym_tpu_torch.batch.BatchSimulation` is the same runtime
over many worlds.

The step is chosen as the JAX package chooses it (``batch.py:77-106``,
``simulation.py:189-243``), with arguments in place of its environment
variables: the mega-step kernel K2 (:mod:`flygym_tpu_torch.ops.megastep`)
on a CUDA device for a model it supports (heightfield terrain included),
the engine step otherwise; a rollout of n steps fuses K = ``megastep_k``
steps per launch when K divides n, and runs one step per launch when it does
not. On terrain the mega-step's ground planes are sampled once per launch
of K steps, or every ``terrain_resample`` steps on the one-step path.

The state is held as a list of shards over a 1-D mesh of devices
(:mod:`flygym_tpu_torch.parallel`), and every step is the sharded one: one
shard on the simulation's device here, as many as the mesh has for a
:class:`~flygym_tpu_torch.batch.BatchSimulation` given ``mesh=``.
"""

from dataclasses import replace
from time import perf_counter_ns
from typing import Literal

import torch

from flygym_tpu_torch.compose.bridge import CompiledModel
from flygym_tpu_torch.engine.step import make_step_sharded, rollout_batched
from flygym_tpu_torch.ops import checked_device
from flygym_tpu_torch.ops.megastep import make_megastep_sharded, megastep_supported
from flygym_tpu_torch.parallel.mesh import gather_world_axis, make_world_mesh, shard_world_axis
from flygym_tpu_torch.utils import checkpoint
from flygym_tpu_torch.utils.profiling import print_perf_report, span

__all__ = ["Simulation"]


def _kind(actuator_type) -> str:
    """An actuator type as its name (``"position"``), from a string or an enum."""
    return str(getattr(actuator_type, "value", actuator_type))


class Simulation:
    """Physics of one world on ``device``.

    Args:
        world: A composed world with at least one fly
            (:class:`~flygym_tpu_torch.compose.world.BaseWorld`), compiled
            here on the CPU; or a :class:`CompiledModel`, e.g. from
            :func:`flygym_tpu_torch.load_compiled` or a world's
            ``compiled``.
        device: Where the model and state live: the card by default; pass
            ``"cpu"`` to run on the CPU.
        megastep: Step through the mega-step kernel. None takes it on a CUDA
            device when the model is supported, and the engine step
            otherwise; True on an unsupported model raises. On the CPU the
            mega-step runs its plain version.
        megastep_k: Steps fused per mega-step launch in rollouts whose
            length it divides.
        terrain_resample: On a heightfield world, the mega-step's ground
            planes are sampled every this many steps on the one-step path
            (:func:`~flygym_tpu_torch.engine.step.rollout_batched`).
    """

    n_worlds = 1
    # Frames of a batch keep their world axis (BatchSimulation).
    _batched_frames = False
    # The mesh the worlds are split over; None is one shard on ``device``.
    mesh = None

    @span("flygym.setup.sim")
    def __init__(self, world, *, device="cuda", megastep: bool | None = None,
                 megastep_k: int = 8, terrain_resample: int = 8) -> None:
        if isinstance(world, CompiledModel):
            self.world, compiled = None, world
        else:
            if len(world.fly_lookup) == 0:
                raise ValueError("The world must contain at least one fly.")
            world.compile()
            self.world, compiled = world, world.compiled
        if not compiled.flies:
            raise ValueError("The compiled world must contain at least one fly.")
        self.compiled = compiled
        self.device = checked_device(device)
        if self.mesh is None:
            self.mesh = make_world_mesh([self.device])
        if megastep_k < 1:
            raise ValueError(f"megastep_k must be >= 1, got {megastep_k}")
        supported = megastep_supported(compiled.model)
        if megastep is None:
            megastep = self.device.type == "cuda" and supported
        elif megastep and not supported:
            raise NotImplementedError("the mega-step kernel does not support this model")
        self.megastep = bool(megastep)
        self.megastep_k = int(megastep_k)
        self.terrain_resample = int(terrain_resample)
        self._megastep_fns = {}
        self.model = compiled.model.to(self.device)
        self._initial_state = self._batch(compiled.initial_state.to(self.device))
        self.state = self._initial_state
        self.renderer = None
        self._map_internal_ids()
        self._clear_counters()

    @property
    def state(self):
        """The state of every world: on a mesh of several devices the shards
        joined on the first one."""
        return gather_world_axis(self._shards)

    @state.setter
    def state(self, value) -> None:
        self._shards = shard_world_axis(value, self.mesh)

    @property
    def shards(self) -> list:
        """The per-shard States, block i on the mesh's device i: what
        :meth:`step_fns`' functions take and give."""
        return self._shards

    @shards.setter
    def shards(self, value: list) -> None:
        if len(value) != self.mesh.size:
            raise ValueError(f"{len(value)} shards given for a mesh of {self.mesh.size}")
        self._shards = list(value)

    def _batch(self, state):
        return state

    # Readouts and trajectories without the world axis (a batch keeps it,
    # one world or more, as the JAX package's ``BatchSimulation`` does).
    _one_world = True

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """A batched readout as this runtime returns it (world 0 here)."""
        return x[0]

    # ------------------------------------------------------------------
    # ID mapping: fly order → model index tensors
    # ------------------------------------------------------------------

    def _map_internal_ids(self) -> None:
        ids = lambda x: torch.tensor(x, dtype=torch.int64, device=self.device)
        self._qpos_adrs, self._qvel_adrs, self._body_ids = {}, {}, {}
        self._site_ids, self._adh_ids, self._sensor_slots = {}, {}, {}
        self._act_ids = {}
        for name, m in self.compiled.flies.items():
            self._qpos_adrs[name] = ids(m["qpos_adrs"])
            self._qvel_adrs[name] = ids(m["qvel_adrs"])
            self._body_ids[name] = ids(m["body_ids"])
            self._site_ids[name] = ids(m["site_ids"])
            self._adh_ids[name] = ids(m["adh_ids"])
            self._sensor_slots[name] = ids(m["sensor_slots"])
            for kind, a in m["act_ids"].items():
                self._act_ids.setdefault(kind, {})[name] = ids(a)
            # Adhesion actuators are read out per leg, in the fly's leg order.
            self._act_ids.setdefault("adhesion", {}).setdefault(name, self._adh_ids[name])

    def actuated_dofs(self, fly_name: str, actuator_type) -> list:
        """The fly's DoFs driven by ``actuator_type``, in input order, as
        (leg, parent link, child link, axis) tuples."""
        return [tuple(d) for d in self.compiled.flies[fly_name]["actuated_dofs"][_kind(actuator_type)]]

    def actuator_ids(self, fly_name: str, actuator_type) -> torch.Tensor:
        """Model actuator indices of the fly's ``actuator_type`` inputs."""
        return self._act_ids[_kind(actuator_type)][fly_name]

    # ------------------------------------------------------------------
    # Stepping
    # ------------------------------------------------------------------

    def _clear_counters(self) -> None:
        """The performance report's counters (``flygym_tpu/simulation.py:
        69-73``)."""
        self._curr_step = 0
        self._frames_rendered = 0
        self._total_physics_time_ns = 0
        self._total_render_time_ns = 0

    def reset(self) -> None:
        """Back to the neutral keyframe at time 0, the counters and the
        renderer's frames cleared."""
        self.state = self._initial_state
        if self.renderer is not None:
            self.renderer.reset()
        self._clear_counters()

    def step(self) -> None:
        """Advance one timestep through the step of a one-step run
        (``step_fns(1)``): K2 at K = 1 on the card for a supported model,
        the engine step otherwise. On a heightfield world, or one with
        compressed pair rows, K2 samples its planes or winners at every
        call."""
        batched_step, _kstep = self.step_fns(1)
        self._shards = batched_step(self._shards)

    def step_with_profile(self) -> None:
        """:meth:`step`, its wall-clock time (the card synchronised before
        the clock is read) and the step added to the report's counters."""
        start = perf_counter_ns()
        self.step()
        self.synchronize()
        self._total_physics_time_ns += perf_counter_ns() - start
        self._curr_step += 1

    def synchronize(self) -> None:
        """Wait for the simulation's cards."""
        for d in dict.fromkeys(self.mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def warmup(self, duration_s: float = 0.05) -> None:
        """Hold the current controls for ``int(duration_s / timestep)``
        steps, so that the start's transients settle, in one rollout without
        trajectory; these steps do not count in the report
        (``flygym_tpu/simulation.py:178-187``)."""
        n_steps = int(duration_s / self.timestep)
        if n_steps > 0:
            self.rollout(None, n_steps, record_trajectory=False)
            self._curr_step -= n_steps

    def step_fns(self, n_steps: int):
        """``(batched_step, kstep_fn)`` for a run of ``n_steps`` steps over
        the mesh, as :func:`~flygym_tpu_torch.engine.step.rollout_batched`
        takes them (JAX's ``_get_megastep_k``): the engine step on each
        shard (:func:`~flygym_tpu_torch.engine.step.make_step_sharded`) and
        None; the K = 1 mega-step and None when ``megastep_k`` does not
        divide ``n_steps``; else None and the K-step mega-step
        (:func:`~flygym_tpu_torch.ops.megastep.make_megastep_sharded`).
        Each takes and gives a list of per-shard States (:attr:`shards`)."""
        if not self.megastep:
            if "engine" not in self._megastep_fns:
                self._megastep_fns["engine"] = make_step_sharded(self.model, self.mesh)
            return self._megastep_fns["engine"], None
        K = self.megastep_k if n_steps % self.megastep_k == 0 else 1
        if K not in self._megastep_fns:
            self._megastep_fns[K] = make_megastep_sharded(self.model, self.mesh, K)
        fn = self._megastep_fns[K]
        return (fn, None) if K == 1 else (None, fn)

    def rollout(self, ctrl_sequence, n_steps: int, *, record_trajectory: bool = True):
        """Run ``n_steps`` steps.

        Args:
            ctrl_sequence: (n_steps, nu) controls in model order for one world,
                (n_steps, n_worlds, nu) for a batch; NaN keeps the previous
                control, and None holds the current controls.

        Returns:
            The qpos trajectory, (n_steps, nq) for one world or
            (n_steps, n_worlds, nq) for a batch (one world too), or None
            without ``record_trajectory``.
        """
        if ctrl_sequence is not None:
            ctrl_sequence = torch.as_tensor(
                ctrl_sequence, dtype=torch.float32, device=self.device
            )
            if ctrl_sequence.shape[0] < n_steps:
                raise ValueError(
                    f"ctrl_sequence has {ctrl_sequence.shape[0]} steps, "
                    f"need at least n_steps={n_steps}"
                )
            ctrl_sequence = ctrl_sequence.reshape(
                ctrl_sequence.shape[0], self.n_worlds, self.model.nu
            )
            ctrl_sequence = shard_world_axis(ctrl_sequence[:n_steps], self.mesh, dim=1)
        batched_step, kstep_fn = self.step_fns(n_steps)
        self._shards, trajs = rollout_batched(
            self._shards, ctrl_sequence, n_steps, batched_step=batched_step, kstep_fn=kstep_fn,
            record=record_trajectory, terrain_resample=self.terrain_resample,
        )
        self._curr_step += n_steps
        if trajs is None:
            return None
        traj = gather_world_axis(trajs, dim=1)
        return traj[:, 0] if self._one_world else traj

    # ------------------------------------------------------------------
    # State readout (fly canonical orders)
    # ------------------------------------------------------------------

    def _read(self, name: str) -> torch.Tensor:
        """The state's field ``name`` of every world (on a mesh of several
        devices, the shards' joined on the first one)."""
        return gather_world_axis([getattr(s, name) for s in self._shards])

    def get_joint_angles(self, fly_name: str) -> torch.Tensor:
        return self._out(self._read("qpos")[:, self._qpos_adrs[fly_name]])

    def get_joint_velocities(self, fly_name: str) -> torch.Tensor:
        return self._out(self._read("qvel")[:, self._qvel_adrs[fly_name]])

    def get_body_positions(self, fly_name: str) -> torch.Tensor:
        return self._out(self._read("xpos")[:, self._body_ids[fly_name]])

    def get_body_rotations(self, fly_name: str) -> torch.Tensor:
        return self._out(self._read("xquat")[:, self._body_ids[fly_name]])

    def get_actuator_forces(self, fly_name: str, actuator_type) -> torch.Tensor:
        ids = self.actuator_ids(fly_name, actuator_type)
        return self._out(self._read("actuator_force")[:, ids])

    def get_site_positions(self, fly_name: str) -> torch.Tensor:
        return self._out(self._read("site_xpos")[:, self._site_ids[fly_name]])

    def get_ground_contact_info(self, fly_name: str) -> tuple:
        """Per-leg (active, force, torque, position, normal, tangent); force
        and torque in the contact frame, the rest in the world frame."""
        data = self._out(self._read("contact_sensordata")[:, self._sensor_slots[fly_name]])
        return (
            data[..., 0],
            data[..., 1:4],
            data[..., 4:7],
            data[..., 7:10],
            data[..., 10:13],
            data[..., 13:16],
        )

    # ------------------------------------------------------------------
    # Control input
    # ------------------------------------------------------------------

    def set_actuator_inputs(self, fly_name: str, actuator_type, inputs) -> None:
        """Set the controls of ``actuator_type``, in the fly's actuated-DoF order."""
        ids = self.actuator_ids(fly_name, actuator_type)
        inputs = torch.as_tensor(inputs, dtype=torch.float32, device=self.device)
        if inputs.shape[-1] != len(ids):
            raise ValueError(
                f"Expected {len(ids)} inputs for actuator type "
                f"'{_kind(actuator_type)}', but got {inputs.shape[-1]}"
            )
        self._set_ctrl(ids, inputs)

    def set_leg_adhesion_states(self, fly_name: str, leg_to_adhesion_state) -> None:
        """Set per-leg adhesion control, in the fly's leg order."""
        ids = self._adh_ids[fly_name]
        values = torch.as_tensor(leg_to_adhesion_state, dtype=torch.float32, device=self.device)
        if values.shape[-1] != len(ids):
            raise ValueError(
                "Unexpected number of adhesion states: "
                f"expected {len(ids)}, got {values.shape[-1]}"
            )
        self._set_ctrl(ids, values)

    def _set_ctrl(self, ids: torch.Tensor, values: torch.Tensor) -> None:
        values = shard_world_axis(values.expand(self.n_worlds, len(ids)), self.mesh)
        shards = []
        for s, v in zip(self._shards, values):
            ctrl = s.ctrl.clone()
            ctrl[:, ids.to(ctrl.device)] = v
            shards.append(replace(s, ctrl=ctrl))
        self._shards = shards

    # ------------------------------------------------------------------
    # Rendering
    # ------------------------------------------------------------------

    def set_renderer(self, cameras, **kwargs):
        """Attach a :class:`~flygym_tpu_torch.render.Renderer` of this
        simulation's world on its device; ``kwargs`` as the renderer takes
        them (``camera_res``, ``playback_speed``, ``world_ids`` ...)."""
        from flygym_tpu_torch.render import Renderer

        self.renderer = Renderer(self.compiled, cameras, device=self.device,
                                 batched=self._batched_frames, **kwargs)
        return self.renderer

    def render_as_needed(self) -> bool:
        """Render a frame if enough simulated time has passed since the last."""
        return self.renderer.render_as_needed(self.state)

    def render_as_needed_with_profile(self) -> bool:
        """:meth:`render_as_needed`, its wall-clock time (the card
        synchronised before the clock is read) added to the report's render
        time, and a frame rendered to its frame count."""
        start = perf_counter_ns()
        done = self.render_as_needed()
        self.synchronize()
        self._total_render_time_ns += perf_counter_ns() - start
        if done:
            self._frames_rendered += 1
        return done

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def save_state(self, path) -> None:
        """Write the state to an npz checkpoint (:mod:`flygym_tpu_torch.utils.
        checkpoint`). One world is written without a world axis, as the JAX
        package's ``Simulation`` writes it; a batch with its world axis."""
        checkpoint.save_state(self.state.map(self._out), path)

    def load_state(self, path) -> None:
        """Restore a state written by :meth:`save_state`, by either package,
        onto this simulation's devices, as its shards are placed
        (:func:`~flygym_tpu_torch.utils.checkpoint.put_like`)."""
        state = checkpoint.load_state(path, device=self.device)
        if self.n_worlds == 1 and state.qpos.dim() == 1:
            state = state.map(lambda x: x[None])
        if state.qpos.dim() != 2 or state.qpos.shape != (self.n_worlds, self.model.nq):
            raise ValueError(f"checkpoint qpos {tuple(state.qpos.shape)} does not fit "
                             f"{self.n_worlds} worlds of nq {self.model.nq}")
        self._shards = checkpoint.put_like(state, self._shards)

    # ------------------------------------------------------------------

    @property
    def time(self) -> float:
        """Simulation time of world 0, in seconds."""
        return float(self._shards[0].time[0])

    @property
    def timestep(self) -> float:
        """Simulation timestep in seconds."""
        return self.model.timestep

    def print_performance_report(
        self, show_in_notebook: bool | Literal["auto"] = "auto"
    ) -> None:
        """The report of the steps taken with :meth:`step_with_profile`."""
        print_perf_report(
            n_steps=self._curr_step,
            n_frames_rendered=self._frames_rendered,
            total_physics_time_ns=self._total_physics_time_ns,
            total_render_time_ns=self._total_render_time_ns,
            timestep=self.timestep,
            show_in_notebook=show_in_notebook,
        )
