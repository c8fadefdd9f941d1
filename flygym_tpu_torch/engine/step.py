"""The full physics step on a batch of worlds.

Port of ``flygym_tpu/engine/step.py`` (lines 36-126, 172-185, 229-316):
FK → motion subspaces → velocities → spatial inertias → CRBA → RNEA bias →
passive and actuator forces → contact solve → semi-implicit Euler with
implicit joint damping (MuJoCo's Euler integrator).

The cached outputs (xpos, sensors, ...) describe the configuration before
integration, as ``MjData`` does after ``mj_step``. Where the reference
scans an episode with ``lax.scan``, :func:`rollout_batched` is a Python loop
of eager steps.
"""

from dataclasses import replace

import torch

from flygym_tpu_torch.engine import actuation, contact, dynamics, sensors
from flygym_tpu_torch.engine.kinematics import (
    dof_subspace,
    geom_poses,
    kinematics_full,
    velocity_pass,
)
from flygym_tpu_torch.engine.maths import quat_integrate
from flygym_tpu_torch.engine.model import ActKind, PhysicsModel, State, compute_site_xpos

__all__ = ["step", "rollout_batched"]


def step(model: PhysicsModel, state: State) -> State:
    """Advance every world of ``state`` by one timestep."""
    dt = model.timestep
    qpos, qvel, ctrl = state.qpos, state.qvel, state.ctrl

    # ---- position stage ----
    xpos, xquat, hinge_xaxis = kinematics_full(model, qpos)
    ref = xpos[:, model.ref_body]
    S = dof_subspace(model, xpos, hinge_xaxis, ref)
    gpos, gquat = geom_poses(model, xpos, xquat)

    # ---- velocity stage ----
    cvel, cacc_bias = velocity_pass(model, qvel, xpos, S)

    # ---- inertia / bias ----
    I_body = dynamics.body_spatial_inertias(model, xpos, xquat, ref)
    M = dynamics.crba(model, I_body, S)
    qfrc_bias = dynamics.rnea_bias(model, I_body, S, cvel, cacc_bias)

    # ---- forces ----
    qfrc_passive = dynamics.passive_forces(model, qpos, qvel)
    qfrc_act, actuator_force = actuation.actuator_forces(
        model, qpos, qvel, ctrl, state.act
    )
    qfrc_smooth = qfrc_passive + qfrc_act - qfrc_bias

    # Implicit joint damping: solve (M + h diag(B)) a = f (MuJoCo Euler).
    Mh = M + dt * torch.diag(model.dof_damping)

    # ---- contacts (adds adhesion forces, solves constraints) ----
    qacc, con_info = contact.solve_contacts(
        model, Mh, qfrc_smooth, qvel, state.qacc, xpos, S, gpos, gquat, ctrl, ref
    )

    # ---- integrate ----
    qvel_new = qvel + dt * qacc
    qpos_new = _integrate_qpos(model, qpos, qvel_new, dt)
    act_new = actuation.integrate_act(model, state.act, ctrl, dt)

    # ---- cached outputs (pre-integration configuration) ----
    sensordata = sensors.contact_sensor_data(model, con_info, qpos.shape[0])
    if model.nu:
        # Adhesion actuators report the commanded force (MuJoCo semantics).
        actuator_force = torch.where(
            model.act_kind == ActKind.ADHESION,
            model.act_gain * actuation.clamp_ctrl(model, ctrl),
            actuator_force,
        )

    return State(
        qpos=qpos_new,
        qvel=qvel_new,
        ctrl=ctrl,
        act=act_new,
        time=state.time + dt,
        qacc=qacc,
        xpos=xpos,
        xquat=xquat,
        site_xpos=compute_site_xpos(model, xpos, xquat),
        actuator_force=actuator_force,
        contact_sensordata=sensordata,
    )


def _integrate_qpos(model: PhysicsModel, qpos, qvel, dt):
    """Semi-implicit Euler position update (quaternion-exact for free roots)."""
    qpos_new = qpos.clone()
    if model.nhinge:
        adr = model.hinge_qadr
        qpos_new[:, adr] = qpos[:, adr] + dt * qvel[:, model.hinge_vadr]
    for _body, qadr, vadr in model.free_joints:
        qpos_new[:, qadr : qadr + 3] = qpos[:, qadr : qadr + 3] + dt * qvel[:, vadr : vadr + 3]
        qpos_new[:, qadr + 3 : qadr + 7] = quat_integrate(
            qpos[:, qadr + 3 : qadr + 7], qvel[:, vadr + 3 : vadr + 6], dt
        )
    return qpos_new


def rollout_batched(
    model: PhysicsModel,
    state: State,
    ctrl_seq: torch.Tensor | None,
    n_steps: int,
    record: bool = True,
):
    """Step ``n_steps`` times.

    Args:
        ctrl_seq: (n_steps, B, nu) controls per step; NaN entries keep the
            previous control. None holds the current controls throughout.
        record: Stack the per-step qpos trajectory.

    Returns:
        (final state, (n_steps, B, nq) qpos trajectory or None).
    """
    traj = []
    for t in range(n_steps):
        if ctrl_seq is not None:
            ctrl_t = ctrl_seq[t]
            state = replace(
                state, ctrl=torch.where(torch.isnan(ctrl_t), state.ctrl, ctrl_t)
            )
        state = step(model, state)
        if record:
            traj.append(state.qpos)
    return state, (torch.stack(traj) if record else None)
