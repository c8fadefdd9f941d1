"""Mass matrix (CRBA) and bias forces (RNEA) as masked matmuls, batch-first.

Port of ``flygym_tpu/engine/dynamics.py``: subtree sums are products with
the (nbody, nbody) subtree mask, and the mass matrix is one
(nv, 6) @ (6, nv) product per world masked by DoF ancestry. Spatial
quantities are world-axis Plücker vectors referenced at the fly root.
"""

import torch

from flygym_tpu_torch.engine.maths import (
    force_cross,
    quat_mul,
    quat_rotate,
    quat_to_mat,
    spatial_inertia,
)
from flygym_tpu_torch.engine.model import PhysicsModel

__all__ = ["body_spatial_inertias", "crba", "rnea_bias", "passive_forces"]


def body_spatial_inertias(model: PhysicsModel, xpos, xquat, ref) -> torch.Tensor:
    """Per-body 6x6 spatial inertia about ``ref`` (B, 3): (B, nbody, 6, 6)."""
    iquat_world = quat_mul(xquat, model.body_iquat)
    R = quat_to_mat(iquat_world)  # principal axes in world
    inertia_world = R @ (model.body_inertia[:, :, None] * R.transpose(-1, -2))
    com_world = xpos + quat_rotate(xquat, model.body_ipos)
    return spatial_inertia(model.body_mass, inertia_world, com_world - ref[:, None])


def crba(model: PhysicsModel, I_body, S) -> torch.Tensor:
    """Composite-rigid-body mass matrix M (B, nv, nv).

    M[i, j] = S_iᵀ I^C_{body(j)} S_j for i ancestor-or-self of j, symmetrised,
    with armature on the diagonal.
    """
    B, nb = I_body.shape[0], model.nbody
    I_comp = (model.body_subtree_mask @ I_body.reshape(B, nb, 36)).reshape(B, nb, 6, 6)
    F = torch.einsum("bdij,bdj->bdi", I_comp[:, model.dof_body], S)
    W = (S @ F.transpose(-1, -2)) * model.dof_ancestor_mask
    M = W + W.transpose(-1, -2) - torch.diag_embed(torch.diagonal(W, dim1=-2, dim2=-1))
    return M + torch.diag(model.dof_armature)


def rnea_bias(model: PhysicsModel, I_body, S, cvel, cacc_bias) -> torch.Tensor:
    """Bias force C(q, qvel) + gravity, (B, nv).

    RNEA's backward pass as a masked matmul: net spatial force per body with
    qacc = 0 (gravity enters as a base acceleration of -g), subtree sums by
    the subtree mask, then projection onto each DoF's subspace.
    """
    a0 = torch.cat([torch.zeros_like(model.gravity), -model.gravity])
    acc = cacc_bias + a0
    f_net = torch.einsum("bnij,bnj->bni", I_body, acc) + force_cross(
        cvel, torch.einsum("bnij,bnj->bni", I_body, cvel)
    )
    f_subtree = model.body_subtree_mask @ f_net
    return torch.sum(S * f_subtree[:, model.dof_body], dim=-1)


def passive_forces(model: PhysicsModel, qpos, qvel) -> torch.Tensor:
    """Joint-level passive spring-damper forces (B, nv)."""
    qfrc = -model.dof_damping * qvel
    if model.nhinge:
        angles = qpos[:, model.hinge_qadr]
        spring = -model.hinge_stiffness * (angles - model.hinge_springref)
        qfrc = qfrc.index_add(1, model.hinge_vadr, spring)
    return qfrc
