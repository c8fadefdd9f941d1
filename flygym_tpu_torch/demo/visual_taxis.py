"""Config 4: visual taxis, the retina-steered CPG walk, over a batch of worlds.

The closed loop of ``examples/07_visual_taxis.py`` (lines 55-70) with one
controller per world. One control step:

1. both eyes of every world render: ``Retina.make_render_batched`` (the
   rows of each world's geoms packed, the retina kernel K3, the acceptance
   blur);
2. each world's drive from its own vision (:func:`object_azimuth_drive`);
3. one CPG step with that drive (the controller's timestep is the model's,
   as example 07 builds it);
4. the targets and the adhesion written into ``ctrl``;
5. ``PHYSICS_PER_CONTROL`` (20) physics steps with ``ctrl`` held, through
   the batch's step (``BatchSimulation.step_fns``): on the K2 path of a
   batch built with ``megastep_k=PHYSICS_PER_CONTROL``, one launch of the
   mega-step kernel K2 fusing them. JAX scans the 20 steps with ``ctrl``
   held, the same computation.

The world is example 07's: ``flygym_tpu_torch/assets/taxis_fly.npz`` (the
benchmark fly spawned at (0, 0, 1.2) and a dark pillar of radius 3 at (25,
12, 3)), whose fly's maps carry its eye bodies.
"""

from dataclasses import replace

import torch

from flygym_tpu_torch.batch import BatchSimulation
from flygym_tpu_torch.control import CPGController, VisualTaxisController
from flygym_tpu_torch.control import extract_preprogrammed_steps
from flygym_tpu_torch.demo.spotlight import MotionSnippet
from flygym_tpu_torch.engine.step import rollout_batched
from flygym_tpu_torch.vision import Retina

__all__ = ["PHYSICS_PER_CONTROL", "TAXIS_GAIN", "TaxisLoop"]

PHYSICS_PER_CONTROL = 20
TAXIS_GAIN = 8.0


class TaxisLoop:
    """Example 07's loop over the worlds of ``sim``.

    Args:
        sim: the batch, unsharded (no ``mesh``); its step is used (build it with
            ``megastep_k=PHYSICS_PER_CONTROL`` for one K2 launch per control
            step).
        controller: None builds the default :class:`VisualTaxisController`
            (gain 8) from the Spotlight clip's step tables and the fly's
            retina.
        fly: the fly's name; None is the world's first fly.
    """

    def __init__(self, sim: BatchSimulation, controller: VisualTaxisController | None = None,
                 fly: str | None = None) -> None:
        self.sim = sim
        fly = fly or sim.compiled.fly_names[0]
        if controller is None:
            steps = extract_preprogrammed_steps(MotionSnippet(), sim.actuated_dofs(fly, "position"))
            cpg = CPGController(steps, timestep=sim.model.timestep, device=sim.device)
            controller = VisualTaxisController(
                cpg=cpg, retina=Retina.for_compiled(sim.compiled, fly), gain=TAXIS_GAIN)
        self.controller = controller
        self._act_ids = sim.actuator_ids(fly, "position")
        self._adh_ids = torch.as_tensor(sim.compiled.flies[fly]["adh_ids"], dtype=torch.int64,
                                        device=sim.device)
        self._step_fns = sim.step_fns(PHYSICS_PER_CONTROL)
        # Both eyes of every world: K3 (its rows packed first), the blur.
        self.render = controller.render_fn(sim.model)

    def init_state(self, generator: torch.Generator | None = None):
        """A CPG state per world, phases drawn from ``generator``."""
        return self.controller.init_state(self.sim.n_worlds, generator)

    def control(self, state, cs, drive: torch.Tensor | None = None):
        """Render → drive → CPG → ``ctrl``: (state with the new controls, new
        CPG state, vision, drive); ``drive`` (B, 6) replaces the rendered
        drive where given."""
        vision = self.render(state)
        state, cs, drive = self.steer(state, cs, vision, drive)
        return state, cs, vision, drive

    def steer(self, state, cs, vision, drive: torch.Tensor | None = None):
        """Vision → drive → CPG → ``ctrl``: (state with the new controls, new
        CPG state, drive)."""
        cs, targets, adhesion, drive = self.controller.steer(cs, vision, drive)
        ctrl = state.ctrl.clone()
        ctrl[:, self._act_ids] = targets
        ctrl[:, self._adh_ids] = adhesion
        return replace(state, ctrl=ctrl), cs, drive

    def physics(self, state):
        """``PHYSICS_PER_CONTROL`` steps with ``ctrl`` held."""
        batched_step, kstep_fn = self._step_fns
        (state,), _ = rollout_batched([state], None, PHYSICS_PER_CONTROL, record=False,
                                      batched_step=batched_step, kstep_fn=kstep_fn,
                                      terrain_resample=self.sim.terrain_resample)
        return state

    def run(self, cs, n_control_steps: int, *, record: bool = False,
            drives: torch.Tensor | None = None):
        """``n_control_steps`` control steps from ``sim.state``, which is
        advanced.

        Args:
            drives: (n_control_steps, B, 6) drives replacing the rendered
                ones, e.g. a JAX golden's.

        Returns:
            (CPG state, per-control-step records or None): with ``record``,
            (n_control_steps, B, ...) ``qpos``, ``qvel`` (after the
            physics steps), ``phase`` (the CPG's), ``drive`` and ``vision``.
        """
        state = self.sim.state
        rec = {"qpos": [], "qvel": [], "phase": [], "drive": [], "vision": []} if record else None
        for t in range(n_control_steps):
            state, cs, vision, drive = self.control(
                state, cs, None if drives is None else drives[t])
            state = self.physics(state)
            if record:
                for key, value in (("qpos", state.qpos), ("qvel", state.qvel),
                                   ("phase", cs.phase), ("drive", drive), ("vision", vision)):
                    rec[key].append(value)
        self.sim.state = state
        if record:
            rec = {k: torch.stack(v) for k, v in rec.items()}
        return cs, rec
