"""The plain env step of config 5: the reference the env cells compare with.

Frozen copies of what ``flygym_tpu_torch/env/gym.py`` (``reset_batched``,
``_advance``, ``_reward_done``, ``_observe_body``), ``olfaction.py``
(``OdorField.sample``) and ``vision.py`` (the retina and the acceptance
blur) compute, over the reference's own model, retina tables and odor
tables, read from the configuration's world file (``meta["env"]``). The
physics steps are :func:`~portbench.reference.runner.plain_chain`; vision
is :func:`~portbench.reference.vision.retina_plain` and the blur.
"""

import ast
from dataclasses import replace

import numpy as np
import torch

from portbench.reference import emitter, vision
from portbench.reference.maths import quat_rotate
from portbench.reference.model import load_world
from portbench.reference.runner import plain_chain

__all__ = ["EnvReference"]

RESET_NOISE = 0.01  # rad (and mm) of Gaussian noise on qpos at reset


class EnvReference:
    """The env of the world file ``path`` on ``device``: its model,
    initial state, index tables, odor tables and, with ``vision``, the
    retina tables and blur matrix."""

    def __init__(self, path, device, *, vision_on: bool, odor_on: bool, decision_interval: int):
        self.model, state0, meta = load_world(path)
        self.static = emitter._Static(self.model)
        self.device = torch.device(device)
        self.state0 = state0.to(self.device)
        env = meta["env"]
        ids = lambda k: torch.tensor(env[k], dtype=torch.int64, device=self.device)
        self.act_ids, self.adh_ids = ids("act_ids"), ids("adh_ids")
        self.qpos_adrs, self.qvel_adrs = ids("qpos_adrs"), ids("qvel_adrs")
        self.sensor_slots, self.tip_bodies = ids("sensor_slots"), ids("tip_bodies")
        self.root_body = int(env["root_body"])
        self.n_actuated = len(env["act_ids"])
        self.decision_interval = int(decision_interval)
        self.free_joints = [tuple(j) for j in self.model.free_joints]
        self.odor = None
        if odor_on:
            odor = env["odor"]
            odor = ast.literal_eval(odor) if isinstance(odor, str) else odor
            f32 = lambda x: torch.as_tensor(np.atleast_2d(np.asarray(x, np.float32)),
                                            device=self.device)
            self.odor = {
                "source_pos": f32(odor["source_pos"]),
                "peak": f32(odor["peak_intensity"]),
                "bodies": torch.as_tensor(np.asarray(odor["sensor_bodies"], np.int64),
                                          device=self.device),
                "offsets": torch.as_tensor(np.asarray(odor["sensor_offsets"], np.float32),
                                           device=self.device),
                "diffusion": odor.get("diffusion", "inverse_square"),
                "gaussian_scale": float(odor.get("gaussian_scale", 10.0)),
            }
        self.tables = self.blur = None
        if vision_on:
            left, right = env["eye_bodies"]
            retina = vision.build_retina(self.model, left_eye_body=left, right_eye_body=right)
            self.retina = retina
            self.tables = vision.RetinaTables(self.model, retina, self.device)
            self.blur = torch.tensor(retina.blur_weights, dtype=torch.float32,
                                     device=self.device)

    def reset(self, generator: torch.Generator, n_envs: int):
        """``reset_batched``: the initial state with RESET_NOISE Gaussian
        noise on qpos from ``generator``, none on free-joint quaternions."""
        noise = RESET_NOISE * torch.randn((n_envs, self.static.nq), generator=generator,
                                          device=generator.device).to(self.device)
        for _b, qadr, _v in self.free_joints:
            noise[:, qadr + 3: qadr + 7] = 0.0
        state = self.state0.map(lambda x: x.expand((n_envs,) + x.shape[1:]).clone())
        return replace(state, qpos=state.qpos + noise)

    def advance(self, state, action: dict, control=None):
        """The action into ``ctrl``, then ``decision_interval`` plain steps."""
        ctrl = state.ctrl.clone()
        ctrl[:, self.act_ids] = action["joints"].expand(ctrl.shape[0], self.n_actuated)
        adhesion = 1.0 + 99.0 * torch.clamp(action["adhesion"], 0.0, 1.0)
        ctrl[:, self.adh_ids] = adhesion.expand(ctrl.shape[0], len(self.adh_ids))
        state = replace(state, ctrl=ctrl)
        seq = ctrl.expand((self.decision_interval,) + ctrl.shape)
        return plain_chain(self.static, state, seq, control)[0]

    def reward_done(self, state):
        root_quat = state.xquat[:, self.root_body]
        heading = quat_rotate(root_quat, root_quat.new_tensor([1.0, 0.0, 0.0]))
        if self.free_joints:
            root_vel = state.qvel[:, 0:3]
        else:
            root_vel = torch.zeros_like(heading)
        reward = torch.sum(root_vel * heading, dim=-1) * 1e-3
        up = quat_rotate(root_quat, root_quat.new_tensor([0.0, 0.0, 1.0]))
        flipped = up[:, 2] < 0.0
        fallen = state.xpos[:, self.root_body, 2] < 0.2
        return reward, flipped | fallen

    def observe(self, state) -> dict:
        force_ids = (torch.arange(self.n_actuated, device=self.device) if self.static.nu == 0
                     else self.act_ids)
        joints = torch.stack([state.qpos[:, self.qpos_adrs], state.qvel[:, self.qvel_adrs],
                              state.actuator_force[:, force_ids]], dim=1)
        root_pos = state.xpos[:, self.root_body]
        root_quat = state.xquat[:, self.root_body]
        if self.free_joints:
            _b, _q, vadr = self.free_joints[0]
            lin_vel = state.qvel[:, vadr: vadr + 3]
            ang_vel = state.qvel[:, vadr + 3: vadr + 6]
        else:
            lin_vel = ang_vel = torch.zeros_like(root_pos)
        heading = quat_rotate(root_quat, root_quat.new_tensor([1.0, 0.0, 0.0]))
        contact = state.contact_sensordata[:, self.sensor_slots]
        obs = {
            "joints": joints,
            "fly": torch.stack([root_pos, lin_vel, heading, ang_vel], dim=1),
            "contact_forces": contact[:, :, 1:4],
            "end_effectors": state.xpos[:, self.tip_bodies],
            "fly_orientation": heading,
        }
        if self.odor is not None:
            obs["odor_intensity"] = self.odor_sample(state)
        if self.tables is not None:
            obs["vision"] = self.render(state)
        return obs

    def odor_sample(self, state) -> torch.Tensor:
        o = self.odor
        pos = state.xpos[:, o["bodies"]] + quat_rotate(state.xquat[:, o["bodies"]], o["offsets"])
        diff = pos[:, None, :, :] - o["source_pos"][None, :, None, :]
        d2 = torch.sum(diff * diff, dim=-1)
        if o["diffusion"] == "inverse_square":
            atten = 1.0 / torch.clamp(d2, min=1e-4)
        else:
            atten = torch.exp(-d2 / (2.0 * o["gaussian_scale"] ** 2))
        return torch.einsum("sd,bsf->bdf", o["peak"], atten)

    def render(self, state) -> torch.Tensor:
        packed = vision.pack_rows(self.tables, state.xpos, state.xquat)
        return vision._mix(self.blur, vision.retina_plain(self.tables, packed))
