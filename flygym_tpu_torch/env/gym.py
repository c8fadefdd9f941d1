"""The functional RL environment, batch-first (config 5: vision and odor).

Port of ``VectorFlyEnv`` in ``flygym_tpu/env/gym.py:69-338``. The spaces
are flygym 1.x's:

- action: dict(joints=(B, n_actuated) target angles, adhesion=(B, 6) in [0, 1]);
- observation: dict(joints=(B, 3, n_actuated) pos/vel/force,
  fly=(B, 4, 3) pos/vel/heading/angular velocity, contact_forces=(B, 6, 3),
  end_effectors=(B, 6, 3), fly_orientation=(B, 3), and with vision
  vision=(B, 2, 721, 2), with an odor field odor_intensity=(B, n_dim, 4)).

An env step sets the action into ``ctrl`` (adhesion as 1 + 99 clip(a)),
runs ``decision_interval`` physics steps, renders, observes, and computes
reward and done. :meth:`VectorFlyEnv.make_batched_step` is the training
path and :meth:`VectorFlyEnv.step` the same step as a method: the physics
steps are one launch of the mega-step kernel K2 fusing them
(``megastep=None`` on the card), or the engine step per substep
(``megastep=False``: the tree-LDL kernels K1/K1b); vision, wherever it is
observed, is one launch of the retina kernel K3 and the acceptance blur
(K3's plain version for CPU tensors).

The world comes as an exported :class:`CompiledModel` with ``meta["env"]``
(``scripts/export_env_golden.py``); random numbers come from explicit
``torch.Generator``s. Not ported: ``FlyEnv`` (it needs ``gymnasium`` and
the camera renderer).
"""

from dataclasses import replace

import torch

from flygym_tpu_torch.compose.bridge import CompiledModel
from flygym_tpu_torch.engine.maths import quat_rotate
from flygym_tpu_torch.engine.model import State
from flygym_tpu_torch.engine.step import step as engine_step
from flygym_tpu_torch.ops import checked_device
from flygym_tpu_torch.ops.megastep import make_megastep, megastep_supported

__all__ = ["VectorFlyEnv"]

RESET_NOISE = 0.01  # rad (and mm) of Gaussian noise on qpos at reset


class VectorFlyEnv:
    """Batched fly environment on ``device``.

    Args:
        compiled: An exported env world, e.g.
            ``load_compiled(flygym_tpu_torch.compose.bridge.ENV_FLY)``.
        device: The card by default; pass ``"cpu"`` to run on the CPU.
        megastep: None takes the mega-step kernel K2 on a CUDA device for a
            supported model, the engine step otherwise; False forces the
            engine step; True on an unsupported model raises. On the CPU the
            mega-step runs its plain version.
        enable_vision: Add the retina's output to the observations,
            rendered by K3 and the blur (``render_vision``).
        odor_field: An :class:`~flygym_tpu_torch.olfaction.OdorField` to add
            odor observations, or None.
    """

    def __init__(self, compiled: CompiledModel, *, device="cuda", megastep: bool | None = None,
                 enable_vision: bool = False, odor_field=None):
        env = compiled.env
        if env is None:
            raise ValueError("the compiled model carries no env metadata (meta['env'])")
        self.device = checked_device(device)
        supported = megastep_supported(compiled.model)
        if megastep is None:
            megastep = self.device.type == "cuda" and supported
        elif megastep and not supported:
            raise NotImplementedError("the mega-step kernel does not support this model")
        self.megastep = bool(megastep)
        self.fly_name = env["fly"]
        self.model = compiled.model.to(self.device)
        self._state0 = compiled.initial_state.to(self.device)
        # Physics steps per env step: 10, a 1 kHz control rate at dt = 1e-4 s.
        self.decision_interval = int(env["decision_interval"])
        self.odor_field = odor_field

        ids = lambda k: torch.tensor(env[k], dtype=torch.int64, device=self.device)
        self._act_ids, self._adh_ids = ids("act_ids"), ids("adh_ids")
        self._qpos_adrs, self._qvel_adrs = ids("qpos_adrs"), ids("qvel_adrs")
        self._sensor_slots, self._tip_bodies = ids("sensor_slots"), ids("tip_bodies")
        self._root_body = int(env["root_body"])
        self.n_actuated = len(env["act_ids"])
        self._megastep_fn = (
            make_megastep(self.model, self.decision_interval) if self.megastep else None
        )
        if enable_vision:
            from flygym_tpu_torch.vision import Retina

            self.retina = Retina.for_compiled(compiled)
            self.render_vision = self.retina.make_render_batched(self.model)
        else:
            self.retina = self.render_vision = None

    # -- reset ----------------------------------------------------------------

    def reset(self, generator: torch.Generator | None = None) -> State:
        """A fresh state of one world (B = 1): the initial state with
        Gaussian noise on qpos, none on free-joint quaternions."""
        return self.reset_batched(generator, 1)

    def reset_batched(self, generator: torch.Generator | None, n_envs: int) -> State:
        """(n_envs,) fresh states, one noise draw each from ``generator``."""
        gen_dev = generator.device if generator is not None else self.device
        noise = RESET_NOISE * torch.randn(
            (n_envs, self.model.nq), generator=generator, device=gen_dev
        ).to(self.device)
        # Gaussian noise would de-normalise the free joints' quaternions.
        for _b, qadr, _v in self.model.free_joints:
            noise[:, qadr + 3 : qadr + 7] = 0.0
        state = self._state0.map(lambda x: x.expand((n_envs,) + x.shape[1:]).clone())
        return replace(state, qpos=state.qpos + noise)

    # -- stepping -------------------------------------------------------------

    def _advance(self, states: State, action: dict) -> State:
        """Set the action into ``ctrl`` and run ``decision_interval`` steps."""
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=self.device)
        ctrl = states.ctrl.clone()
        ctrl[:, self._act_ids] = f32(action["joints"]).expand(ctrl.shape[0], self.n_actuated)
        adhesion = 1.0 + 99.0 * torch.clamp(f32(action["adhesion"]), 0.0, 1.0)
        ctrl[:, self._adh_ids] = adhesion.expand(ctrl.shape[0], len(self._adh_ids))
        states = replace(states, ctrl=ctrl)
        if self._megastep_fn is None:
            for _ in range(self.decision_interval):
                states = engine_step(self.model, states)
            return states
        if self.decision_interval == 1:
            return self._megastep_fn(states)
        seq = ctrl.expand((self.decision_interval,) + ctrl.shape)
        states, _qpos_rows = self._megastep_fn(states, seq)
        return states

    def step(self, states: State, action: dict):
        """One env step of every world.

        Returns:
            (states, obs dict, reward (B,), done (B,), info dict)
        """
        states = self._advance(states, action)
        reward, done = self._reward_done(states)
        return states, self.observe(states), reward, done, {}

    def _reward_done(self, states: State):
        root_quat = states.xquat[:, self._root_body]
        heading = quat_rotate(root_quat, root_quat.new_tensor([1.0, 0.0, 0.0]))
        if self.model.free_joints:
            root_vel = states.qvel[:, 0:3]
        else:
            root_vel = torch.zeros_like(heading)
        reward = torch.sum(root_vel * heading, dim=-1) * 1e-3  # forward speed
        up = quat_rotate(root_quat, root_quat.new_tensor([0.0, 0.0, 1.0]))
        flipped = up[:, 2] < 0.0
        fallen = states.xpos[:, self._root_body, 2] < 0.2
        return reward, flipped | fallen

    def make_batched_step(self, *, auto_reset: bool = False):
        """The training step: ``(states, action) -> (states, obs, reward,
        done, info)`` over every world, with vision through K3 and the blur.

        With ``auto_reset=True`` the function takes a ``torch.Generator``
        after the action: worlds that are done are replaced by fresh reset
        states and observed after the reset, while reward and done report
        the step that ended them.
        """
        if not auto_reset:
            return self.step

        def step_batched_autoreset(states: State, action: dict, generator):
            states = self._advance(states, action)
            reward, done = self._reward_done(states)
            fresh = self.reset_batched(generator, states.qpos.shape[0])

            def pick(new, old):
                mask = done.reshape((-1,) + (1,) * (old.ndim - 1))
                return torch.where(mask, new, old)

            states = State(**{
                name: pick(getattr(fresh, name), getattr(states, name))
                for name in State.__dataclass_fields__
            })
            return states, self.observe(states), reward, done, {}

        return step_batched_autoreset

    def observe(self, states: State) -> dict:
        """The observation dict (flygym 1.x layout), vision through K3 and
        the blur."""
        obs = self._observe_body(states)
        if self.render_vision is not None:
            obs["vision"] = self.render_vision(states)
        return obs

    def _observe_body(self, states: State) -> dict:
        """Every observation but vision."""
        if self.model.nu == 0:
            force_ids = torch.arange(self.n_actuated, device=self.device)
        else:
            force_ids = self._act_ids
        joints = torch.stack(
            [
                states.qpos[:, self._qpos_adrs],
                states.qvel[:, self._qvel_adrs],
                states.actuator_force[:, force_ids],
            ],
            dim=1,
        )
        root_pos = states.xpos[:, self._root_body]
        root_quat = states.xquat[:, self._root_body]
        if self.model.free_joints:
            _b, _q, vadr = self.model.free_joints[0]
            lin_vel = states.qvel[:, vadr : vadr + 3]
            ang_vel = states.qvel[:, vadr + 3 : vadr + 6]
        else:
            lin_vel = ang_vel = torch.zeros_like(root_pos)
        heading = quat_rotate(root_quat, root_quat.new_tensor([1.0, 0.0, 0.0]))
        contact = states.contact_sensordata[:, self._sensor_slots]
        obs = {
            "joints": joints,
            "fly": torch.stack([root_pos, lin_vel, heading, ang_vel], dim=1),
            "contact_forces": contact[:, :, 1:4],
            "end_effectors": states.xpos[:, self._tip_bodies],
            "fly_orientation": heading,
        }
        if self.odor_field is not None:
            obs["odor_intensity"] = self.odor_field.sample(self.model, states)
        return obs

    @property
    def timestep(self) -> float:
        return self.model.timestep * self.decision_interval
