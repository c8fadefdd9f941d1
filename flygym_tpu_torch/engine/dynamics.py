"""Mass matrix (CRBA) and bias forces (RNEA) as masked matmuls, batch-first.

Port of ``flygym_tpu/engine/dynamics.py``: subtree sums are products with
the (nbody, nbody) subtree mask, and the mass matrix is one
(nv, 6) @ (6, nv) product per world masked by DoF ancestry. Spatial
quantities are world-axis Plücker vectors referenced at the fly root.
"""

import torch

from flygym_tpu_torch.engine.maths import (
    fma32,
    force_cross,
    matmul_fma,
    quat_mul,
    quat_mul_fma,
    quat_rotate,
    quat_rotate_fma,
    quat_to_mat,
    skew,
    spatial_inertia,
)
from flygym_tpu_torch.engine.model import PhysicsModel

__all__ = [
    "body_spatial_inertias",
    "spatial_inertia_fused",
    "crba",
    "rnea_bias",
    "passive_forces",
]


def body_spatial_inertias(model: PhysicsModel, xpos, xquat, ref,
                          fused: bool = False) -> torch.Tensor:
    """Per-body 6x6 spatial inertia about ``ref`` (B, 3): (B, nbody, 6, 6).

    ``fused`` rounds as the JAX package's jitted mass matrix does on the
    CPU, stage by stage from ``R`` on: ``quat_mul_fma`` for the principal
    axes' quaternion and ``quat_rotate_fma`` for the com, XLA's dot order
    for the 3 x 3 products (:func:`matmul_fma`) and one fused multiply-add
    for ``I + m c cᵀ``. ``R`` itself is still ``quat_to_mat``'s, which the
    jitted program does not round so (``ROADMAP.md`` queue 3 item 7)."""
    if not fused:
        iquat_world = quat_mul(xquat, model.body_iquat)
        R = quat_to_mat(iquat_world)  # principal axes in world
        inertia_world = R @ (model.body_inertia[:, :, None] * R.transpose(-1, -2))
        com_world = xpos + quat_rotate(xquat, model.body_ipos)
        return spatial_inertia(model.body_mass, inertia_world, com_world - ref[:, None])
    R = quat_to_mat(quat_mul_fma(xquat, model.body_iquat))
    return spatial_inertia_fused(model, R, xpos + quat_rotate_fma(xquat, model.body_ipos), ref)


def spatial_inertia_fused(model: PhysicsModel, R, com_world, ref) -> torch.Tensor:
    """The stages of ``body_spatial_inertias(..., fused=True)`` after ``R``
    (B, nbody, 3, 3) and the com (B, nbody, 3)."""
    inertia_world = matmul_fma(R, model.body_inertia[:, :, None] * R.transpose(-1, -2))
    c = skew(com_world - ref[:, None])
    ct = c.transpose(-1, -2)
    m = model.body_mass[:, None, None].expand(c.shape)
    top_left = fma32(m, matmul_fma(c, ct), inertia_world)
    eye = torch.eye(3, dtype=c.dtype, device=c.device).expand(c.shape)
    return torch.cat([torch.cat([top_left, m * c], dim=-1),
                      torch.cat([m * ct, m * eye], dim=-1)], dim=-2)


def crba(model: PhysicsModel, I_body, S, fused: bool = False) -> torch.Tensor:
    """Composite-rigid-body mass matrix M (B, nv, nv).

    M[i, j] = S_iᵀ I^C_{body(j)} S_j for i ancestor-or-self of j, symmetrised,
    with armature on the diagonal. ``fused`` sums the three products in the
    jitted JAX program's orders (:func:`matmul_fma`); the step sums them as
    torch does.
    """
    B, nb, nv = I_body.shape[0], model.nbody, model.nv
    if fused:
        # XLA's CPU dot picks its kernel by the shape; these lane counts are
        # the ones it showed at the committed worlds' shapes (below 64 rows
        # or columns, one chain).
        mask = model.body_subtree_mask.expand(B, nb, nb)
        I_comp = matmul_fma(mask, I_body.reshape(B, nb, 36), lanes=4 if nb >= 64 else 1)
        I_comp = I_comp.reshape(B, nb, 6, 6)
        F = matmul_fma(I_comp[:, model.dof_body], S[..., None])[..., 0]
        W = matmul_fma(S, F.transpose(-1, -2), lanes=2 if nv > 64 else 1)
        W = W * model.dof_ancestor_mask
    else:
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
