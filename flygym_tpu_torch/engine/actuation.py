"""Actuator force models, batch-first.

Port of ``flygym_tpu/engine/actuation.py:95-207`` for the two kinds the
benchmark fly uses: ``POSITION`` (a joint force ``kp (ctrl - q) - kv q̇``)
and ``ADHESION`` (zero here: the contact solver applies its force along the
contact normals). Models with any other kind, or with activation states, are
refused when they are loaded (:mod:`flygym_tpu_torch.compose.bridge`).
"""

import torch

from flygym_tpu_torch.engine.model import ActKind, PhysicsModel

__all__ = ["SUPPORTED_KINDS", "clamp_ctrl", "actuator_forces", "integrate_act"]

SUPPORTED_KINDS = (ActKind.POSITION, ActKind.ADHESION)


def clamp_ctrl(model: PhysicsModel, ctrl: torch.Tensor) -> torch.Tensor:
    """Controls clipped to their range where the actuator is ctrl-limited."""
    lo, hi = model.act_ctrlrange[:, 0], model.act_ctrlrange[:, 1]
    return torch.where(
        model.act_ctrllimited > 0, torch.minimum(torch.maximum(ctrl, lo), hi), ctrl
    )


def actuator_forces(model: PhysicsModel, qpos, qvel, ctrl, act):
    """Per-actuator scalar forces and the generalised force vector.

    Returns:
        qfrc_actuator: (B, nv)
        actuator_force: (B, nu); adhesion rows are 0 here and filled by the
            step with the commanded force.
    """
    B = qpos.shape[0]
    if model.nu == 0:
        return qpos.new_zeros((B, model.nv)), qpos.new_zeros((B, 0))

    c = clamp_ctrl(model, ctrl)
    hs = torch.clamp(model.act_hinge, min=0)
    q = qpos[:, model.hinge_qadr[hs]]
    v = qvel[:, model.hinge_vadr[hs]]
    force = torch.where(
        model.act_kind == ActKind.POSITION,
        model.act_gain * (c - q) - model.act_kv * v,
        torch.zeros_like(c),
    )
    flo, fhi = model.act_forcerange[:, 0], model.act_forcerange[:, 1]
    force = torch.where(
        model.act_forcelimited > 0, torch.minimum(torch.maximum(force, flo), fhi), force
    )

    joint_force = torch.where(model.act_hinge >= 0, force, torch.zeros_like(force))
    qfrc = qpos.new_zeros((B, model.nv)).index_add(1, model.hinge_vadr[hs], joint_force)
    return qfrc, force


def integrate_act(model: PhysicsModel, act, ctrl, dt):
    """Advance activation states: none exist in the models the port loads."""
    if model.na:
        raise NotImplementedError("activation dynamics (na > 0) are not ported")
    return act
