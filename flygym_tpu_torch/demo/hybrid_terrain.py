"""Config 3: the hybrid controller on blocks terrain, over a batch of worlds.

The closed loop of ``examples/08_hybrid_rugged_terrain.py`` (lines 79-101)
with one controller per world. Each physics step reads every world's leg
tip heights (``xpos`` of the six ``tarsus5`` bodies), the contact force in
world axes from the contact sensors (the frame force's normal and first
tangential components along the sensor's normal and tangent), and the
heading (body 1's x axis); the :class:`HybridController` turns them into
joint targets and adhesion, written into ``ctrl``; then one step of the
simulation's chosen one-step function runs (the mega-step kernel K2 on the
card). On terrain the mega-step's ground planes are sampled as
:func:`~flygym_tpu_torch.engine.step.rollout_batched` samples them: every
``terrain_resample`` steps when that number divides the run's length, else
at every step.

The worlds' roots are moved apart before the settle (uniform in ±20 mm from
a seeded generator; the terrain spans ±40 mm), so that the flies do not all
stand on one spot of the terrain.
"""

from dataclasses import replace

import torch

from flygym_tpu_torch.batch import BatchSimulation
from flygym_tpu_torch.control import CPGController, HybridController, HybridState
from flygym_tpu_torch.control import extract_preprogrammed_steps
from flygym_tpu_torch.demo.spotlight import MotionSnippet
from flygym_tpu_torch.engine.kinematics import forward_kinematics
from flygym_tpu_torch.engine.maths import quat_rotate
from flygym_tpu_torch.engine.model import compute_site_xpos

__all__ = ["ROOT_OFFSET_MM", "HybridLoop", "place_roots", "root_offsets"]

ROOT_OFFSET_MM = 20.0


def root_offsets(n_worlds: int, generator: torch.Generator | None = None,
                 device="cuda") -> torch.Tensor:
    """(n_worlds, 2) root xy offsets, uniform in ±``ROOT_OFFSET_MM``."""
    u = torch.rand((n_worlds, 2), generator=generator, device=device)
    return (2.0 * u - 1.0) * ROOT_OFFSET_MM


def place_roots(sim: BatchSimulation, offsets: torch.Tensor, root: int = 0) -> None:
    """Move each world's free root (the world's ``root``-th free joint: its
    first fly's by default) by its (x, y) offset and redo the forward
    kinematics the state caches."""
    _body, qadr, _vadr = sim.model.free_joints[root]
    qpos = sim.state.qpos.clone()
    qpos[:, qadr:qadr + 2] += offsets.to(qpos)
    xpos, xquat = forward_kinematics(sim.model, qpos)
    site = compute_site_xpos(sim.model, xpos, xquat)
    sim.state = replace(sim.state, qpos=qpos, xpos=xpos, xquat=xquat, site_xpos=site)


class HybridLoop:
    """Example 08's loop over the worlds of ``sim``.

    Args:
        sim: the batch, unsharded (no ``mesh``), on terrain or flat ground;
            its step choice (K2 or the engine step) and ``terrain_resample``
            are used.
        controller: None builds the default :class:`HybridController` from
            the Spotlight clip's step tables.
        fly: the fly's name; None is the world's first fly.
    """

    def __init__(self, sim: BatchSimulation, controller: HybridController | None = None,
                 fly: str | None = None) -> None:
        self.sim = sim
        fly = fly or sim.compiled.fly_names[0]
        maps = sim.compiled.flies[fly]
        if controller is None:
            steps = extract_preprogrammed_steps(MotionSnippet(),
                                                sim.actuated_dofs(fly, "position"))
            controller = HybridController(
                cpg=CPGController(steps, timestep=sim.model.timestep, device=sim.device))
        self.controller = controller
        ids = lambda x: torch.as_tensor(x, dtype=torch.int64, device=sim.device)
        self._act_ids = sim.actuator_ids(fly, "position")
        self._adh_ids = ids(maps["adh_ids"])
        self._tips = ids(maps["tip_bodies"])
        self._slots = ids(maps["sensor_slots"])
        self._x_axis = torch.tensor([1.0, 0.0, 0.0], device=sim.device)
        batched_step, _kstep = sim.step_fns(1)
        self.batched_step = batched_step
        self.sample_planes = None
        if batched_step.sample_planes is not None:
            self.sample_planes = lambda state: batched_step.sample_planes([state])[0]

    def init_state(self, generator: torch.Generator | None = None) -> HybridState:
        """A controller state per world, phases drawn from ``generator``."""
        return self.controller.init_state(self.sim.n_worlds, generator)

    def control(self, state, cs: HybridState):
        """Readouts → controller → ``ctrl``: (state with the new controls,
        new controller state)."""
        tip_z = state.xpos[:, self._tips, 2]
        sensor = state.contact_sensordata[:, self._slots]
        ff = sensor[..., 1:4]
        f_world = ff[..., 0:1] * sensor[..., 10:13] + ff[..., 1:2] * sensor[..., 13:16]
        heading = quat_rotate(state.xquat[:, 1], self._x_axis)
        cs, targets, adhesion = self.controller(cs, tip_z, f_world, heading)
        ctrl = state.ctrl.clone()
        ctrl[:, self._act_ids] = targets
        ctrl[:, self._adh_ids] = adhesion
        return replace(state, ctrl=ctrl), cs

    def physics_step(self, state, planes=None):
        """One step of the simulation's one-step function."""
        if planes is None:
            (state,) = self.batched_step([state])
        else:
            (state,) = self.batched_step([state], [planes])
        return state

    def run(self, cs: HybridState, n_steps: int, *, record: bool = False):
        """``n_steps`` closed-loop steps from ``sim.state``, which is
        advanced.

        Returns:
            (controller state, per-step records or None): with ``record``,
            (n_steps, B, ...) ``qpos``, ``qvel`` and ``sensordata``.
        """
        resample = self.sim.terrain_resample
        chunked = self.sample_planes is not None and resample > 1 and n_steps % resample == 0
        state, planes = self.sim.state, None
        rec = {"qpos": [], "qvel": [], "sensordata": []} if record else None
        for t in range(n_steps):
            if chunked and t % resample == 0:
                planes = self.sample_planes(state)
            state, cs = self.control(state, cs)
            state = self.physics_step(state, planes)
            if record:
                rec["qpos"].append(state.qpos)
                rec["qvel"].append(state.qvel)
                rec["sensordata"].append(state.contact_sensordata)
        self.sim.state = state
        if record:
            rec = {k: torch.stack(v) for k, v in rec.items()}
        return cs, rec
