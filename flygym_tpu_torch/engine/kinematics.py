"""Forward kinematics and velocity propagation over the body tree, batch-first.

Port of ``flygym_tpu/engine/kinematics.py``. FK composes each body's local
transform along the model's ancestor-jump tables (parent, grandparent, 4th
ancestor, ...): four gather-and-compose rounds for the fly's tree. That is
fewer tensor ops than a loop over the tree's levels, and it composes the
transforms in the reference's order, so the port rounds where JAX does.

Spatial quantities are 6D Plücker vectors ``(angular, linear)`` in world
axes, referenced at the position of ``model.ref_body`` (the fly root).
"""

import torch

from flygym_tpu_torch.engine.maths import (
    cross,
    motion_cross,
    quat_from_axis_angle,
    quat_mul_fma,
    quat_rotate_fma,
)
from flygym_tpu_torch.engine.maths import quat_mul as _quat_mul
from flygym_tpu_torch.engine.maths import quat_rotate as _quat_rotate
from flygym_tpu_torch.engine.model import PhysicsModel

__all__ = [
    "forward_kinematics",
    "kinematics_full",
    "dof_subspace",
    "velocity_pass",
    "geom_poses",
]


def forward_kinematics(model: PhysicsModel, qpos: torch.Tensor, fused: bool = False):
    """Body world poses (B, nbody, 3) and (B, nbody, 4) from (B, nq) qpos.

    ``fused`` rounds the quaternion products and rotations as the JAX
    package's jitted programs do on the CPU (``quat_mul_fma``,
    ``quat_rotate_fma``); the step rounds them one operation at a time."""
    xpos, xquat, _ = kinematics_full(model, qpos, fused)
    return xpos, xquat


def _local_transforms(model: PhysicsModel, qpos: torch.Tensor, fused: bool = False):
    """Per-body local transform in the parent frame, plus per-hinge prefixes.

    Returns (lpos (B, nb, 3), lquat (B, nb, 4), hinge_prefix (B, nh, 4)): the
    last is the within-body rotation accumulated before each hinge.
    """
    quat_mul = quat_mul_fma if fused else _quat_mul
    B, nb = qpos.shape[0], model.nbody
    # Made on the device (a host list would be a copy from the host at
    # every call, which a CUDA graph cannot hold).
    identity = torch.eye(1, 4, dtype=qpos.dtype, device=qpos.device)[0]

    if model.nhinge:
        angles = qpos[:, model.hinge_qadr]
        hq = quat_from_axis_angle(model.hinge_axis, angles)  # (B, nh, 4)
        hq_pad = torch.cat([hq, identity.expand(B, 1, 4)], dim=1)
        idx = torch.where(
            model.body_hinge_idx >= 0, model.body_hinge_idx, model.nhinge
        )
        q0 = hq_pad[:, idx[:, 0]]  # (B, nb, 4)
        q01 = quat_mul(q0, hq_pad[:, idx[:, 1]])
        jq = quat_mul(q01, hq_pad[:, idx[:, 2]])
        prefix_by_slot = torch.stack(
            [identity.expand(B, nb, 4), q0, q01], dim=2
        )  # (B, nb, 3, 4)
        hinge_prefix = prefix_by_slot[:, model.hinge_body, model.hinge_slot]
    else:
        jq = identity.expand(B, nb, 4)
        hinge_prefix = qpos.new_zeros((B, 0, 4))

    lquat = quat_mul(model.body_quat, jq)
    lpos = model.body_pos.expand(B, nb, 3).clone()
    # Free bodies: the local transform is the qpos pose (parent is world).
    for body, qadr, _vadr in model.free_joints:
        lpos[:, body] = qpos[:, qadr : qadr + 3]
        lquat[:, body] = qpos[:, qadr + 3 : qadr + 7]
    return lpos, lquat, hinge_prefix


def kinematics_full(model: PhysicsModel, qpos: torch.Tensor, fused: bool = False):
    """FK along the ancestor jumps; also returns per-hinge world axes.

    The world axis of hinge k uses the rotation accumulated before that
    hinge (later hinges of the same body do not leave it invariant).
    ``fused`` as for :func:`forward_kinematics`.

    Returns:
        xpos: (B, nbody, 3), xquat: (B, nbody, 4), hinge_xaxis: (B, nhinge, 3).
    """
    quat_mul = quat_mul_fma if fused else _quat_mul
    quat_rotate = quat_rotate_fma if fused else _quat_rotate
    pos, quat, hinge_prefix = _local_transforms(model, qpos, fused)
    # After round k, (pos, quat)[b] is the transform from b's 2^(k+1)-th
    # ancestor (or the world) to b.
    for jump in model.ancestor_jumps:
        pq = quat[:, jump]
        pos = pos[:, jump] + quat_rotate(pq, pos)
        quat = quat_mul(pq, quat)
    xpos, xquat = pos, quat

    if model.nhinge:
        parent_q = xquat[:, model.body_parent[model.hinge_body]]
        base = quat_mul(parent_q, model.body_quat[model.hinge_body])
        pre = quat_mul(base, hinge_prefix)
        hinge_xaxis = quat_rotate(pre, model.hinge_axis)
    else:
        hinge_xaxis = qpos.new_zeros((qpos.shape[0], 0, 3))
    return xpos, xquat, hinge_xaxis


def dof_subspace(model: PhysicsModel, xpos, hinge_xaxis, ref) -> torch.Tensor:
    """Motion subspace S (B, nv, 6) of every DoF, referenced at ``ref`` (B, 3).

    - free translation DoFs: (0; e_i)
    - free rotation DoFs:    (e_i; (p - ref) × e_i), anchored at body origin p
    - hinge DoFs:            (a; (p - ref) × a), world axis a, anchor p
    """
    B = xpos.shape[0]
    S = xpos.new_zeros((B, model.nv, 6))
    if model.nhinge:
        anchor = xpos[:, model.hinge_body] - ref[:, None]
        lin = cross(anchor, hinge_xaxis)
        S[:, model.hinge_vadr] = torch.cat([hinge_xaxis, lin], dim=-1)

    eye = torch.eye(3, dtype=xpos.dtype, device=xpos.device)
    for body, _qadr, vadr in model.free_joints:
        p = xpos[:, body] - ref  # (B, 3)
        S[:, vadr : vadr + 3, 3:] = eye
        S[:, vadr + 3 : vadr + 6, :3] = eye
        S[:, vadr + 3 : vadr + 6, 3:] = cross(p[:, None, :], eye)
    return S


def velocity_pass(model: PhysicsModel, qvel, xpos, S):
    """Spatial velocities and velocity-product (bias) accelerations.

    cvel[b]      = Σ_{d ∈ ancestors(b)} S_d q̇_d
    cacc_bias[b] = Σ_{d ∈ ancestors(b)} v_dof(d) ×̂ (S_d q̇_d)
    plus the exact free-joint Ṡ q̇ term (0; ṗ × ω) over each free subtree.

    Returns:
        cvel: (B, nbody, 6), cacc_bias: (B, nbody, 6).
    """
    Sqd = S * qvel[..., None]  # (B, nv, 6)
    affects_t = model.body_subtree_mask[model.dof_body].T  # (nbody, nv)
    cvel = affects_t @ Sqd

    # Velocity at each DoF's virtual body (ancestor-or-self sum).
    v_dof = model.dof_ancestor_mask.T @ Sqd
    g = motion_cross(v_dof, Sqd)
    # The generic formula holds for hinge DoFs; free-joint DoFs get their
    # exact term below.
    if model.free_joints:
        hinge_mask = torch.ones(model.nv, dtype=qvel.dtype, device=qvel.device)
        for _body, _qadr, vadr in model.free_joints:
            hinge_mask[vadr : vadr + 6] = 0.0
        g = g * hinge_mask[:, None]
    cacc = affects_t @ g

    for body, _qadr, vadr in model.free_joints:
        v_lin = qvel[:, vadr : vadr + 3]
        omega = qvel[:, vadr + 3 : vadr + 6]
        c_free = torch.cat([torch.zeros_like(v_lin), cross(v_lin, omega)], dim=-1)
        cacc = cacc + model.body_subtree_mask[body][:, None] * c_free[:, None, :]
    return cvel, cacc


def geom_poses(model: PhysicsModel, xpos, xquat, fused: bool = False):
    """World poses of all geoms: (B, ngeom, 3) positions, (B, ngeom, 4) quats.

    ``fused`` rounds as the JAX package's jitted ``Renderer`` does
    (``quat_rotate_fma``, ``quat_mul_fma``); the step, whose K2 path is
    bit-equal to the engine's, keeps the plain products."""
    quat_mul = quat_mul_fma if fused else _quat_mul
    quat_rotate = quat_rotate_fma if fused else _quat_rotate
    b = model.geom_body
    gpos = xpos[:, b] + quat_rotate(xquat[:, b], model.geom_pos)
    gquat = quat_mul(xquat[:, b], model.geom_quat)
    return gpos, gquat
