"""Single-world simulation runtime.

Port of ``flygym_tpu/simulation.py`` (lines 88-150 and 306-392): construct
from a compiled model, roll out, read state in the fly's canonical orders
and write control inputs. The state is a batch of one world (B = 1); getters
return that world. :class:`flygym_tpu_torch.batch.BatchSimulation` is the
same runtime over many worlds.
"""

from dataclasses import replace

import torch

from flygym_tpu_torch.compose.bridge import CompiledModel
from flygym_tpu_torch.engine.step import rollout_batched

__all__ = ["Simulation"]


def _kind(actuator_type) -> str:
    """An actuator type as its name (``"position"``), from a string or an enum."""
    return str(getattr(actuator_type, "value", actuator_type))


class Simulation:
    """Physics of one world on ``device``.

    Args:
        compiled: A :class:`CompiledModel`, e.g. from
            :func:`flygym_tpu_torch.load_compiled`.
        device: Where the model and state live (``"cpu"`` or ``"cuda"``).
    """

    n_worlds = 1

    def __init__(self, compiled: CompiledModel, *, device="cpu") -> None:
        if not compiled.flies:
            raise ValueError("The compiled world must contain at least one fly.")
        self.compiled = compiled
        self.device = torch.device(device)
        self.model = compiled.model.to(self.device)
        self._initial_state = self._batch(compiled.initial_state.to(self.device))
        self.state = self._initial_state
        self._map_internal_ids()

    def _batch(self, state):
        return state

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

    def reset(self) -> None:
        """Back to the neutral keyframe at time 0."""
        self.state = self._initial_state

    def rollout(self, ctrl_sequence, n_steps: int, *, record_trajectory: bool = True):
        """Run ``n_steps`` steps.

        Args:
            ctrl_sequence: (n_steps, nu) controls in model order for one world,
                (n_steps, n_worlds, nu) for a batch; NaN keeps the previous
                control, and None holds the current controls.

        Returns:
            The qpos trajectory, (n_steps, nq) or (n_steps, n_worlds, nq),
            or None without ``record_trajectory``.
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
        self.state, traj = rollout_batched(
            self.model, self.state, ctrl_sequence, n_steps, record=record_trajectory
        )
        if traj is None:
            return None
        return traj if self.n_worlds > 1 else traj[:, 0]

    # ------------------------------------------------------------------
    # State readout (fly canonical orders)
    # ------------------------------------------------------------------

    def get_joint_angles(self, fly_name: str) -> torch.Tensor:
        return self._out(self.state.qpos[:, self._qpos_adrs[fly_name]])

    def get_joint_velocities(self, fly_name: str) -> torch.Tensor:
        return self._out(self.state.qvel[:, self._qvel_adrs[fly_name]])

    def get_body_positions(self, fly_name: str) -> torch.Tensor:
        return self._out(self.state.xpos[:, self._body_ids[fly_name]])

    def get_body_rotations(self, fly_name: str) -> torch.Tensor:
        return self._out(self.state.xquat[:, self._body_ids[fly_name]])

    def get_actuator_forces(self, fly_name: str, actuator_type) -> torch.Tensor:
        ids = self.actuator_ids(fly_name, actuator_type)
        return self._out(self.state.actuator_force[:, ids])

    def get_site_positions(self, fly_name: str) -> torch.Tensor:
        return self._out(self.state.site_xpos[:, self._site_ids[fly_name]])

    def get_ground_contact_info(self, fly_name: str) -> tuple:
        """Per-leg (active, force, torque, position, normal, tangent); force
        and torque in the contact frame, the rest in the world frame."""
        data = self._out(self.state.contact_sensordata[:, self._sensor_slots[fly_name]])
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
        ctrl = self.state.ctrl.clone()
        ctrl[:, ids] = values.expand(self.n_worlds, len(ids))
        self.state = replace(self.state, ctrl=ctrl)

    # ------------------------------------------------------------------

    @property
    def time(self) -> float:
        """Simulation time of world 0, in seconds."""
        return float(self.state.time[0])
