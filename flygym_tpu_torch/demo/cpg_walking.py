"""Config 2: CPG walking on flat ground, over a batch of worlds.

The loop of ``examples/04_cpg_walking.py`` (lines 44-53) with one CPG per
world: at every physics step one CPG step at drive 1.0, the targets and the
adhesion written into ``ctrl``, then one physics step (one K = 1 launch of
the mega-step kernel K2 on the K2 path, the engine step otherwise). The
world is example 04's: ``flygym_tpu_torch/assets/cpg_fly.npz``, the
benchmark fly spawned at (0, 0, 1.2).
"""

from dataclasses import replace

import torch

from flygym_tpu_torch.batch import BatchSimulation
from flygym_tpu_torch.control import CPGController, extract_preprogrammed_steps
from flygym_tpu_torch.demo.spotlight import MotionSnippet

__all__ = ["CPGWalkingLoop"]


class CPGWalkingLoop:
    """Example 04's loop over the worlds of ``sim``.

    Args:
        sim: the batch, unsharded (no ``mesh``); its step choice (K2 or the
            engine step) is used.
        controller: None builds the default :class:`CPGController` from the
            Spotlight clip's step tables, timestep the model's.
        fly: the fly's name; None is the world's first fly.
    """

    def __init__(self, sim: BatchSimulation, controller: CPGController | None = None,
                 fly: str | None = None) -> None:
        self.sim = sim
        fly = fly or sim.compiled.fly_names[0]
        if controller is None:
            steps = extract_preprogrammed_steps(MotionSnippet(), sim.actuated_dofs(fly, "position"))
            controller = CPGController(steps, timestep=sim.model.timestep, device=sim.device)
        self.controller = controller
        self._act_ids = sim.actuator_ids(fly, "position")
        self._adh_ids = torch.as_tensor(sim.compiled.flies[fly]["adh_ids"], dtype=torch.int64,
                                        device=sim.device)
        self.batched_step, _kstep = sim.step_fns(1)

    def init_state(self, generator: torch.Generator | None = None):
        """A CPG state per world, phases drawn from ``generator``."""
        return self.controller.init_state(self.sim.n_worlds, generator)

    def step(self, state, cs):
        """One CPG step and one physics step: (state, CPG state)."""
        cs, targets, adhesion = self.controller(cs, drive=1.0)
        ctrl = state.ctrl.clone()
        ctrl[:, self._act_ids] = targets
        ctrl[:, self._adh_ids] = adhesion
        state = replace(state, ctrl=ctrl)
        (state,) = self.batched_step([state])
        return state, cs

    def run(self, cs, n_steps: int, *, record: bool = False):
        """``n_steps`` steps from ``sim.state``, which is advanced.

        Returns:
            (CPG state, per-step records or None): with ``record``,
            (n_steps, B, ...) ``qpos``, ``qvel`` and ``phase``.
        """
        state = self.sim.state
        rec = {"qpos": [], "qvel": [], "phase": []} if record else None
        for _ in range(n_steps):
            state, cs = self.step(state, cs)
            if record:
                for key, value in (("qpos", state.qpos), ("qvel", state.qvel),
                                   ("phase", cs.phase)):
                    rec[key].append(value)
        self.sim.state = state
        if record:
            rec = {k: torch.stack(v) for k, v in rec.items()}
        return cs, rec
