"""The RL environments (config 5: vision and odor).

Port of ``flygym_tpu/env/gym.py``: ``VectorFlyEnv`` (:69-338), the
functional env, batch-first, and ``FlyEnv`` (:341-432), a ``gymnasium.Env``
of one world around it. The spaces are flygym 1.x's:

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

The env builds its world as JAX's does: with no world it composes
:func:`_build_default_world` (the flagship walking fly on flat ground),
and a composed world (``compose``) is compiled and its tables read from the
compile's name maps and the fly's actuators, legs and contact sensors. An
exported :class:`CompiledModel` with ``meta["env"]``
(``scripts/export_env_golden.py``) is taken as well, its tables read from
the metadata. Random numbers come from explicit ``torch.Generator``s.
``FlyEnv`` imports ``gymnasium`` when it is built; its frame, a fixed camera
behind and above the root body, is :func:`env_frame`, which needs no
``gymnasium``.
"""

import numpy as np

from dataclasses import replace

import torch

from flygym_tpu_torch.compose.bridge import CompiledModel
from flygym_tpu_torch.compose.fly import ActuatorType
from flygym_tpu_torch.engine.maths import quat_rotate
from flygym_tpu_torch.engine.model import State
from flygym_tpu_torch.engine.step import step as engine_step
from flygym_tpu_torch.ops import checked_device
from flygym_tpu_torch.ops.megastep import make_megastep, megastep_supported

__all__ = ["FlyEnv", "VectorFlyEnv", "env_frame", "world_tables"]

RESET_NOISE = 0.01  # rad (and mm) of Gaussian noise on qpos at reset
# FlyEnv's frame: 240 x 320 pixels, fovy 30 deg, 7.5 mm behind and 6 mm
# above the root, its axes x (1, 0, 0) and y (0, 0.6, 0.8) in the world
# (the tracking camera's): a rotation about x by atan2(0.8, 0.6).
FRAME_RES = (240, 320)
FRAME_FOVY = 30.0
FRAME_OFFSET = (0.0, -7.5, 6.0)
FRAME_QUAT = (0.8944271909999159, 0.447213595499958, 0.0, 0.0)  # (sqrt 0.8, sqrt 0.2, 0, 0)


def _build_default_world(fly_name: str = "fly0"):
    """``(fly, world)``: JAX's default env world (``flygym_tpu/env/gym.py:
    35-67``): a LEGS_ONLY fly (yaw-pitch-roll), position actuators at kp 50
    on the LEGS_ACTIVE_ONLY DoFs with the neutral pose as their input, leg
    adhesion, on :class:`FlatGroundWorld` at (0, 0, 1.2)."""
    from flygym_tpu_torch.anatomy import ActuatedDOFPreset, AxisOrder, JointPreset, Skeleton
    from flygym_tpu_torch.compose import FlatGroundWorld, Fly, KinematicPosePreset
    from flygym_tpu_torch.utils.math import Rotation3D

    fly = Fly(name=fly_name)
    skeleton = Skeleton(axis_order=AxisOrder.YAW_PITCH_ROLL, joint_preset=JointPreset.LEGS_ONLY)
    fly.add_joints(skeleton, neutral_pose=KinematicPosePreset.NEUTRAL)
    dofs = fly.skeleton.get_actuated_dofs_from_preset(ActuatedDOFPreset.LEGS_ACTIVE_ONLY)
    fly.add_actuators(dofs, ActuatorType.POSITION, kp=50.0,
                      neutral_input=KinematicPosePreset.NEUTRAL)
    fly.add_leg_adhesion()
    world = FlatGroundWorld()
    world.add_fly(fly, (0, 0, 1.2), Rotation3D("quat", (1, 0, 0, 0)))
    return fly, world


def world_tables(world, fly_name: str) -> dict:
    """The env's index tables of ``fly_name`` in a compiled ``world``
    (``world.compiled``), as JAX's ``VectorFlyEnv.__init__`` reads them
    (``flygym_tpu/env/gym.py:112-153``), with the keys of ``meta["env"]``:
    ``act_ids`` (the position actuators), ``adh_ids`` (adhesion, legs in
    order), ``qpos_adrs`` and ``qvel_adrs`` (the actuated hinges),
    ``root_body``, ``tip_bodies`` (the tarsus5 segments) and
    ``sensor_slots`` (the legs' ground-contact sensors)."""
    c = world.compiled
    fly = world.fly_lookup[fly_name]
    legs = fly.get_legs_order()
    order = fly.get_actuated_jointdofs_order(ActuatorType.POSITION)
    sensors = world.legpos_to_groundcontactsensors_by_fly[fly_name]
    return {
        "act_ids": [c.actuator_name2id[a.full_identifier]
                    for a in fly.jointdof_to_specactuator_by_type[ActuatorType.POSITION].values()],
        "adh_ids": [c.actuator_name2id[fly.leg_to_adhesionactuator[leg].full_identifier]
                    for leg in legs],
        "qpos_adrs": [c.hinge_qadr[f"{fly_name}/{d.name}"] for d in order],
        "qvel_adrs": [c.hinge_vadr[f"{fly_name}/{d.name}"] for d in order],
        "root_body": c.body_name2id[f"{fly_name}/{fly.root_segment.name}"],
        "tip_bodies": [c.body_name2id[f"{fly_name}/{leg}_tarsus5"] for leg in legs],
        "sensor_slots": [c.sensor_name2slot[sensors[leg].full_identifier] for leg in legs],
    }


class VectorFlyEnv:
    """Batched fly environment on ``device``.

    Args:
        world: A composed world (``compose``), compiled here as JAX's env
            compiles it (``world.compile()``); None composes
            :func:`_build_default_world`. An exported env world
            (``load_compiled(flygym_tpu_torch.compose.bridge.ENV_FLY)``, a
            :class:`CompiledModel` with ``meta["env"]``) is taken too.
        fly_name: Which fly is the agent (default: the world's first; an
            exported env's own).
        decision_interval: Physics steps per env step: 10, a 1 kHz control
            rate at dt = 1e-4 s.
        enable_vision: Add the retina's output to the observations,
            rendered by K3 and the blur (``render_vision``).
        odor_field: An :class:`~flygym_tpu_torch.olfaction.OdorField` to add
            odor observations, or None.
        device: The card by default; pass ``"cpu"`` to run on the CPU.
        megastep: None takes the mega-step kernel K2 on a CUDA device for a
            supported model, the engine step otherwise; False forces the
            engine step; True on an unsupported model raises. On the CPU the
            mega-step runs its plain version.

    ``world``, ``fly`` and ``fly_name`` are JAX's attributes; ``world`` and
    ``fly`` are None for an exported env.
    """

    def __init__(self, world=None, fly_name: str | None = None, *, decision_interval: int = 10,
                 enable_vision: bool = False, odor_field=None, device="cuda",
                 megastep: bool | None = None):
        self.device = checked_device(device)
        if isinstance(world, CompiledModel):
            compiled, tables = world, world.env
            if tables is None:
                raise ValueError("the compiled model carries no env metadata (meta['env'])")
            if fly_name is not None and fly_name != tables["fly"]:
                raise ValueError(f"the env's fly is {tables['fly']!r}, not {fly_name!r}")
            self.world = self.fly = None
            self.fly_name = tables["fly"]
        else:
            if world is None:
                fly, world = _build_default_world()
                fly_name = fly.name
            if fly_name is None:
                fly_name = next(iter(world.fly_lookup))
            world.compile()
            compiled, tables = world.compiled, world_tables(world, fly_name)
            self.world, self.fly, self.fly_name = world, world.fly_lookup[fly_name], fly_name
        supported = megastep_supported(compiled.model)
        if megastep is None:
            megastep = self.device.type == "cuda" and supported
        elif megastep and not supported:
            raise NotImplementedError("the mega-step kernel does not support this model")
        self.megastep = bool(megastep)
        self.model = compiled.model.to(self.device)
        self._state0 = compiled.initial_state.to(self.device)
        self.decision_interval = int(decision_interval)
        self.odor_field = odor_field

        ids = lambda k: torch.tensor(tables[k], dtype=torch.int64, device=self.device)
        self._act_ids, self._adh_ids = ids("act_ids"), ids("adh_ids")
        self._qpos_adrs, self._qvel_adrs = ids("qpos_adrs"), ids("qvel_adrs")
        self._sensor_slots, self._tip_bodies = ids("sensor_slots"), ids("tip_bodies")
        self._root_body = int(tables["root_body"])
        self.n_actuated = len(tables["act_ids"])
        self._megastep_fn = (
            make_megastep(self.model, self.decision_interval) if self.megastep else None
        )
        if enable_vision:
            from flygym_tpu_torch.vision import Retina

            if self.world is None:
                self.retina = Retina.for_compiled(compiled)
            else:
                self.retina = Retina.for_fly(self.world, self.fly_name)
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


def env_frame(model, states: State, root_body: int, height: int = FRAME_RES[0],
              width: int = FRAME_RES[1]) -> torch.Tensor:
    """``FlyEnv``'s frame of every world: (B, H, W, 3) floats in [0, 1] on
    the states' device, from a camera fixed 7.5 mm behind and 6 mm above the
    root body (``flygym_tpu/env/gym.py:408-430``), capsules only, rounded as
    JAX's eager ``render_pixels`` there rounds (``fused=False``)."""
    from flygym_tpu_torch.engine.kinematics import geom_poses
    from flygym_tpu_torch.render.raycast import capsule_mask, render_pixels

    gpos, gquat = geom_poses(model, states.xpos, states.xquat)
    B = gpos.shape[0]
    cam_pos = states.xpos[:, root_body] + gpos.new_tensor(FRAME_OFFSET)
    cam_quat = gpos.new_tensor(FRAME_QUAT).expand(B, 4)
    return render_pixels(model, gpos, gquat, cam_pos, cam_quat, height, width, FRAME_FOVY,
                         capsule_mask(model), fused=False)


class FlyEnv:
    """A ``gymnasium.Env`` of one world around :class:`VectorFlyEnv`.

    Args:
        args, kwargs: :class:`VectorFlyEnv`'s (the world, the fly's name,
            ``decision_interval``, ``enable_vision``, ``odor_field``,
            ``device``, ``megastep``), passed on as JAX's ``FlyEnv`` passes
            them (``flygym_tpu/env/gym.py:341-346``).
        render_camera: Kept, as JAX keeps it; :meth:`render` takes its
            fixed camera.

    Observations are numpy arrays without the world axis, the action a dict
    of (n_actuated,) joint targets and (6,) adhesion. ``reset(seed=)``
    seeds the ``torch.Generator`` of the reset noise (seed 0 before the
    first seeded reset).
    """

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, *args, render_camera: str | None = None, **kwargs):
        import gymnasium
        from gymnasium import spaces

        self._core = VectorFlyEnv(*args, **kwargs)
        self._render_camera = render_camera
        self._state = None
        self._generator = torch.Generator().manual_seed(0)
        n = self._core.n_actuated
        self.action_space = spaces.Dict({
            "joints": spaces.Box(-np.pi, np.pi, shape=(n,), dtype=np.float32),
            "adhesion": spaces.Box(0.0, 1.0, shape=(6,), dtype=np.float32),
        })
        obs_spaces = {
            "joints": spaces.Box(-np.inf, np.inf, (3, n), dtype=np.float32),
            "fly": spaces.Box(-np.inf, np.inf, (4, 3), dtype=np.float32),
            "contact_forces": spaces.Box(-np.inf, np.inf, (6, 3), np.float32),
            "end_effectors": spaces.Box(-np.inf, np.inf, (6, 3), np.float32),
            "fly_orientation": spaces.Box(-1.0, 1.0, (3,), np.float32),
        }
        if self._core.retina is not None:
            obs_spaces["vision"] = spaces.Box(
                0.0, 1.0, (2, self._core.retina.n_ommatidia, 2), np.float32)
        if self._core.odor_field is not None:
            obs_spaces["odor_intensity"] = spaces.Box(
                0.0, np.inf, (self._core.odor_field.n_dimensions, 4), np.float32)
        self.observation_space = spaces.Dict(obs_spaces)
        self._gymnasium = gymnasium

    @staticmethod
    def _host(obs: dict) -> dict:
        return {k: v[0].cpu().numpy() for k, v in obs.items()}

    def reset(self, *, seed: int | None = None, options=None):
        if seed is not None:
            self._generator.manual_seed(seed)
        self._state = self._core.reset(self._generator)
        return self._host(self._core.observe(self._state)), {}

    def step(self, action: dict):
        action = {k: torch.as_tensor(np.asarray(action[k]), dtype=torch.float32)
                  for k in ("joints", "adhesion")}
        self._state, obs, reward, done, info = self._core.step(self._state, action)
        return self._host(obs), float(reward[0]), bool(done[0]), False, info

    def render(self) -> np.ndarray:
        """The frame of :func:`env_frame` as (240, 320, 3) uint8."""
        frame = env_frame(self._core.model, self._state, self._core._root_body)
        return (frame[0] * 255).to(torch.uint8).cpu().numpy()

    def close(self):
        pass
